"""Chip smoke test of the PyTorch / CUDA port (siddhi_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. the card: name and power limit from nvidia-smi;
  2. build: compiles the kernel sources of siddhi_tpu_torch/csrc/
     with nvcc, one process each, all started together;
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
  9. a profiled sweep of config 1: device busy time, idle share, top ops;
 10. the join kernels length_window (K5), join_lanes (K6) and join_probe
     (K7), with filter_compact and time_window on the join sides, against
     their plain versions stage by stage (exact): at J1's shape (bench.py's
     windowed join, length(128) windows, 8192 rows a side), at J2's shape
     (2^20-row windows filled over 8 sends of 131,072 rows, then a steady
     send), on small joins (full / left / right outer, the grid path with
     a side filter and a non-equi ON, time sides with TIMER steps, having,
     batches longer than their windows), and a lane table with a forced
     overflow that both versions must report, as numpy counts it;
 11. per-kernel times of K5-K7 at J1's and J2's shapes (CUDA-graph
     replays) beside their plain versions and bounds;
 12. J1 (bench.py config_windowed_join: 1 warm and 16 timed sends) and J2
     (the enrichment join, 2^20-row windows, 131,072 Orders and 131,072
     Fills a send: 8 filling sends, 32 timed, one more whose Orders rows
     are held in full to numpy) through SiddhiManager, every step's
     [n_valid, n_current, n_dropped] held to a numpy recount, ev/s and
     per-send p50 / p99, then a profiled sweep of J2;
 13. J3: the two join samples whole (16,384 events a side a send, 16
     sends), with the recount and the outer-join sample's second query;
 14. block_nfa (K8) against its plain version stage by stage (state words,
     dropped, header, valid rows; exact): S1's shape (bench.py's
     config_sequence_within, 2,048 events), S1-wide's (131,072 events,
     1,024 chunks), the pattern sample's (16,384 events), a sequence
     without `every`, a two-slot slab that overflows at chunk boundaries,
     batches with invalid rows, ts-delta and raw-ts wires, and the edge
     cases of K8_EDGE_CASES at 8,192 events (first matches past event 96
     of a chunk, seeds that never match on falling prices, `within` cuts
     inside a chunk, runs of over 32 invalid rows in a sequence); then K8 per
     launch at S1's and S1-wide's shapes (CUDA-graph replays) beside its
     plain version and its bound;
 15. pattern_step with an absent atom against its plain version (wakes
     included) on A1's data steps (2^20-key slab; dense and gather,
     ts-delta and raw-ts), on timer launches over the whole slab (one that
     fires a block, one at the same time that fires nothing) and on random
     traffic without padding rows; then its times at A1's data step and
     timer step beside their bounds;
 16. S1 (1 warm + 32 timed sends), S1-wide (1 + 16, then a profiled sweep)
     and S2 (16 sends, then the same sends again with every step held to
     the plain version) through SiddhiManager: S1's match counts equal
     their closed form on every send, K8 launched, its plain version never
     called;
 17. A1 (the partitioned absent rule at 2^20 keys: 8 filling + 16 timed
     sends, then a profiled sweep): exactly the odd keys of each block
     fire, once each, at e1.ts + 1000, through timer-mode launches; A2:
     the absent corpus's shapes with standalone absent atoms and the idle
     advance, the JAX package's events;
 18. table_write (K9: the row write, duplicate slots in one batch
     included, and the masked delete), table_match (K10, dense and over
     index candidates) and join_probe's table modes (K7: the grid over a
     table and the table fast path) against their plain versions on the
     card, stage by stage, through twin runtimes fed the same sends (one
     launching the kernels, one calling the plain versions): every K7 and
     K10 output, both tables after every send (exact): T1's 2^20-row
     shape with a send of duplicate new and existing keys, freed-row
     reuse, a masked delete, K10 dense at 4,096 x 4,096 and 2^20 x 1,024,
     K10 over @Index candidates (K > 1), K7's grid inner and left outer;
 19. their times per launch (CUDA-graph replays) at T1's and T2's shapes
     beside their plain versions and bounds (and the one torch call that
     computes the masked delete);
 20. T1 (the query guide's upsert + enrichment at 2^20 rows: 8 filling
     sends, 16 timed sends of 131,072 upserts and 131,072 probes; every
     join header, the last send's rows and the whole table via rt.query
     held to a numpy model; then a profiled sweep with the host time of
     the indexed match and the allocator), T2 (the table_crud sample,
     4,096 symbols, the table held to numpy after each of 16 sends) and
     T3 (the table corpus's shapes, the JAX package's events), every
     kernel launched and no plain version called;
 21. keyed_window (K11) against its plain version on the card, stage by
     stage (every emitted row, the wake and the whole slab after every
     step; exact): at P1's shape (length(10), 2^20 keys, 131,072 events a
     send, a hot key of 100 events), at P2's (time(1 sec), 4,096 keys x
     256 rows: data steps, TIMER ticks over all keys, an out-of-order send
     with a key above its capacity, a tick that expires every row) and a
     filtered lengthBatch(3) at P2's traffic (many keys flushing in one
     step); every step with padding key rows counted; then group_agg's run
     mode against its plain version on P1's rows (2^20 slots);
 22. K11's time per launch by mode (CUDA-graph replays from a restored
     slab) beside its plain version and the bound of the bytes the step
     must move, and group_agg's run mode at P1's shape;
 23. P1 (the query guide's per-device rolling maximum at 2^20 devices: 8
     filling sends and 2 more held row by row to a numpy model, 16 timed
     sends) and P2 (per-symbol 1-second volume, 4,096 symbols x 32 events
     a send 250 ms apart, every send's TIMER tick and data step held row
     by row to numpy), each with ev/s, per-send p50 / p99 and a profiled
     sweep with the host time of the key grouping and the group slots;
     P3 (the partition corpus, small, the JAX package's events); K11 and
     K4 (and K1 for the windowless sample) launched, no plain version
     called;
 24. R1: each output rate form over a single-stream, a join, a pattern
     and a partitioned query, the JAX package's events;
 25. in_probe (K14: the hash-set build and the lookup) against its plain
     version (the reference's dense compare) at IN1's shape (a 2^20-row
     LONG column, 131,072 probes) and at edge values (int nulls, a LONG
     operand over an INT column, -0.0 / +0.0 and NaN, bools, the set's
     own EMPTY key, an all-invalid table); the bytecode's IN inside K1
     (IN1's filter), pattern_step (the flagship with e1 probing a
     65,536-row table, 2^20 keys, 131,072 keys x 4 events), K8 (S1-wide
     with a probe) and K11 (P1 with a probe) against their plain
     versions; time_batch (K12) against its plain version at W1's shape
     (two 2^21-row buffers: filling steps, a first flush, a steady flush
     of 2,097,153 rows, out-of-order timestamps, TIMER flushes with and
     without a pending slice) and order_limit (K13) on the steady flush's
     rows (avgTemp desc limit 10, a two-key order, -0.0 / NaN and int and
     long nulls under ASC and DESC, an empty step); all exact;
 26. their times (CUDA-graph replays) beside their plain versions,
     bounds and library calls (torch.isin, torch.sort(stable=True)), and
     each OP_IN kernel beside the same kernel without the probe;
 27. W1 (the query guide's Limit & Offset example: timeBatch(10 min),
     4,000 groups, avg desc, limit 10; 8 filling, 32 timed and 8 checked
     sends of 131,072 readings, the checked flush's delivered rows held
     to a numpy model of the reference) and IN1 (T1's upsert with the
     guide's `in` condition at 2^20 rows: every send's delivered trades
     held to numpy's isin over the table model), each with ev/s, per-send
     p50 / p99 and a profiled sweep;
 28. J1G (J1 with group by L.symbol and sum(R.qty): every delivered row
     holds its symbol's running sum in emission order);
 29. post_filter (K15) against its plain version on every step that
     reached it in PF1's runtime (131,072-row TIMER and data steps), in a
     keyed timeBatch, with `in Table`, nulls and bool columns, and after
     every top-level window; keyed_window's timeBatch mode against its
     plain version at KT1's shape (65,536 keys x 128: data steps, a tick
     at one boundary, a tick flushing every key across collapsed
     boundaries, arrivals past the boundary, a key above its capacity with
     missed rows) and its time mode at RP1's (4 keys x 4,194,304: in-order
     sends and ticks, the ordered-ring path, then late readings) and
     P2's (late trades after in-order rings, one key above its
     capacity); group_agg's radix mode against
     its plain version at PG1's 2^21 slots and on random rows with RESET
     epochs; all exact;
 30. their times (CUDA-graph replays) beside their plain versions and
     bounds: K15 at a PF1 data step, K11 timeBatch at a tick flushing every
     KT1 key and at a KT1 data step, K11 time at an RP1 data step, K4
     radix at a PG1 send;
 31. RP1 (the query guide's range-partition example, 10-minute windows
     per area at 10,000 devices: every tick's and data step's rows held
     to a numpy model), KT1 (a per-device tumbling minute at 65,536
     devices: a flush round's 65,536 flushes held to a numpy model), PG1
     (a per-device running maximum over churning devices under @purge at
     2^21 group slots: every row against a model that forgets idle
     devices, the allocator's size against it) and PF1 (config 1 with a
     filter after its window: every send's counts against numpy), each
     with ev/s, per-send p50 / p99 and a profiled sweep;
 33. ext_window (K16: externalTime, timeLength, delay), sort_window (K17),
     time_batch's external mode (K12), keyed_window's session mode (K11)
     and group_agg's refcount pass (K4) against their plain versions,
     step by step (exact): at EX1's shape (epoch-ms event times jittered
     out of order, the window filling to 1.97M rows; a send without
     arrivals; a small window dropping survivors), TL1's (length
     evictions, timer ticks), DL1's, SO1's (NaN, +inf and -0.0 prices
     among them; an int-key window with LONG_MIN and BIG_SEQ keys and a
     filter), XB1's (flushes of about 262,144 rows), SE1's (2^20 keys x
     256 rows, a tick over every key, late joins over many keys, a hot
     key above capacity; top-level session(gap) on one key row, with a
     262,144-row session of late joins) and DC1's (2^20 pair slots);
 34. their times (CUDA-graph replays) beside their plain versions and
     bounds (K16's the bytes a window step needs, its full rewrite
     beside), K17 beside torch.topk of the same keys;
 35. EX1 (externalTime(1 min) at 4,096 devices), XB1 (externalTimeBatch(1
     sec)), TL1 (timeLength(10 sec, 1048576) under playback), DL1
     (delay(1 sec)), SO1 (a standing top 1,000), SE1 (clickstream
     sessions at 2^20 users) and DC1 (distinct users per IP at 2^20 pair
     slots), each held to a numpy model on its checked sends, with ev/s,
     per-send p50 / p99 and a profiled sweep (the launch counts are read
     before the sweep);
 36. X2: the slice's corpus against the JAX package's events;
 37. time_batch's chunk and cron modes (K12), hop_window (K18), frequent
     (K19) and keyed_window's latency mode (K11) against their plain
     versions, step by step (exact): at CB1's shape (131,072-row chunks, a
     TIMER step that keeps the chunk), CR1's (fires flushing 655,360
     pending rows while the fire step's arrivals start the next batch),
     HP1's (the window filling past 700,000 rows, a hop at a TIMER step,
     hops collapsed, a small window whose kept rows overflow), FQ1's
     (1,000 counters; 20,000 counters in device memory; float keys of two
     columns with -0.0 and NaN payloads; FQ_EDGE_CASES: a full miss
     mid-group, repeated new keys in a group, a full miss evicting every
     counter, keys colliding in the walk's hash, a batch of only hits)
     and SL1's (2^20 keys x 2 x 128
     rows: late clicks into both sessions, merges, a tick over every key,
     a hot key above capacity written out of ts order);
 38. their times (CUDA-graph replays) beside their plain versions and
     bounds;
 39. CB1 (batch() at 4,096 price levels), CR1 (the API reference's cron
     every 5 s at 4,096 symbols), HP1 (hopping(1 min, 10 sec) over 10,000
     sensors), FQ1 (the API reference's PotentialFraud lossyFrequent over
     2^20 cards drawn Zipf(1.1)) and SL1 (session(5 sec, user, 2 sec) at
     2^20 users, late clicks), each held to a numpy model on its checked
     sends, with ev/s, per-send p50 / p99 and a profiled sweep;
 40. X2's cases of these kinds against the JAX package's events;
 41. keyed_ext.cu's four kernels K20 (externalTime, timeLength, delay),
     K21 (externalTimeBatch, batch, cron), K22 (sort) and K23 (hopping),
     eight windows kept per partition key, against their plain versions
     step by step (exact: every row, the wake and missed words, every
     key's slab) at 65,536 keys: from empty and filled slabs, padding key
     rows, a TIMER row beside every key row's arrivals, out-of-order event
     times, ticks over every key, collapsed hops, a batch() key growing
     its slab, sort keys of -inf, NaN and -0, a key past its capacity,
     and keys of 8,192 rows (the global workspace);
 42. their times (CUDA-graph replays from a restored slab) beside their
     plain versions and bounds, K22 beside torch.topk of the same keys;
 43. KX1 (externalTime per device), KXB1 (externalTimeBatch per device),
     KSO1 (a top 10 per symbol) and KHP1 (hopping per sensor, two ticks a
     send over every key), each at 65,536 keys, held to a numpy model on
     its checked sends (the selector's RESET epochs across keys), with
     ev/s, per-send p50 / p99 and a profiled sweep;
 44. X3: the keyed corpus against the JAX package's events;
 45-48. keyed_freq (K24) and expr_window (K25, K26) against their plain
     versions, their times, KFQ1, EW1 and KEB1 through SiddhiManager, and
     X4 (`slice12_phases`);
 49. pattern_step's general mode and its timer pass against their plain
     versions from one state (state words, dropped, header, rows and wake
     after every step): fifteen forms (`GEN_FORMS`: `+`, `<0:>`, `<0:1>`,
     `<2:4>`, `<1:>` over two streams of different widths, and, or,
     instant and timed absent pairs, an absent chain with a count atom, a
     leading absent atom, a partitioned sequence, a non-`every` or, and
     aggregators with having in both modes) on random traffic at 65,536
     keys, every general-mode step of every X5 case (`x5_twins`), then
     two sends each of PK1, CP1, LG1 and TP1 at full size and TP1's timer
     step over 2^20 keys;
 50. the general mode's time per launch at those sends, at TP1's timer
     step and at a top-level count plan (one key, 1,024 events) beside
     its plain version and the bound of the bytes each step must move;
 51. PK1 (the query guide's counting sequence at 2^20 devices: 3 sweeps
     held pair for pair to an independent model of the slots), CP1 (its
     counting pattern at 65,536 rooms: every round held to a closed form),
     LG1 (its logical pattern with having, 65,536 rooms: every round held
     to a model) and TP1 (a timed `not X for t and Y` at 2^20 keys: the
     even keys of each block fire at their deadlines through timer-mode
     launches), each with ev/s and per-send p50 / p99;
 52. X5: the pattern corpus at the top level and in a value partition,
     the guide's examples, and aggregators over a count pattern in a
     range partition, against the JAX package's events.
 53. agg_base (K27) and agg_merge (K28) against their plain versions on
     the card (exact; NaN equal to NaN, -0.0 apart from +0.0): K27 over
     every column type with nulls of each, +-inf, -0.0, a filter,
     padding, EXPIRED and TIMER rows, an empty and an all-filtered batch,
     and AG1's send; K28 on slot -1 rows, +-inf, -0.0, one slot of 4,096
     rows whose f64 sum depends on its order, and AG1's shapes (6
     durations x 7 bases x 2^20 buckets);
 54. their times (CUDA-graph replays) beside their plain versions, their
     bounds and, for K28, one `scatter_reduce_` per (duration, base);
 55. AG1 (the query guide's TradeAggregation: 4,096 symbols, 160 sends of
     131,072 trades a second, 1% null prices and volumes, seconds to
     years; every retained (symbol, second) and every (symbol, minute)
     bucket held to numpy, f64 equal) and AGJ1 on its state (the guide's
     `within ... per "seconds"` join, 4,096 requests a send over the last
     60 s, rows and counts held to numpy; an on-demand read per "hours"),
     then NW1 (the guide's shared time(10 sec) window, 131,072 readings a
     second, about 1.31M rows alive, its reader held to the closed form)
     and TR1 (a trigger every second joined with it, 1,179,648 pairs a
     trigger, held to the closed form), each with ev/s, per-send p50 /
     p99 and a profiled sweep;
 56. X14: every window kind as a named window (read, joined, read on
     demand) and the named-window join apps against the JAX package's
     events, and a bidirectional named-window join on the card against
     its plain run.
57-67. the dispatch layer and sharding (`slice15_phases`,
     `slice16_phases`);
 68. K33 `fill_probe` against its plain version, a numpy count of the
     state brought to the host and `count_nonzero` on the JAX layout's
     alive masks: W1's timeBatch state, HP1's hop buffers and config 1's
     2^24-row ring;
 69. config 1 at full width with `@app:statistics('BASIC')` and the
     probe on every dispatch, against statistics alone and against both
     off: ev/s, p50 / p99, K33 launched and its plain version never, the
     state report's window fill equal to the ring's count, the probe
     adding no device-to-host copy, and Prometheus / health touching the
     device 0 times;
 70. the flagship at full width with the observatory on (its default)
     and off: ev/s, the hotness feed's host ms a send, the flagship's
     distinct keys and hot share.
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


def general_plans(dev, ql, qname, sid):
    """The general mode's kernel plans (the data step on `sid`, the timer
    step or None) for a query that the flagship mode runs, planned while
    `flagship_subset` answers no: to time the general mode on the
    flagship's and A1's plans beside the flagship mode."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps
    saved = ps.flagship_subset
    ps.flagship_subset = lambda spec: False
    try:
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    finally:
        ps.flagship_subset = saved
    planned = rt.query_runtimes[qname].planned
    kp = planned.dense_steps_w[sid].kernel_plan
    ts = planned.timer_step
    tkp = None if ts is None else ts.kernel_plan
    if not kp.general or (tkp is not None and not tkp.general):
        fail(f"{qname}: the forced plan is not the general mode's")
    return kp, tkp


def same_launch(torch, restore, state, launch, kp, gkp, label):
    """One launch of the flagship mode's plan `kp` and one of the general
    mode's `gkp` for the same query, each from the restored state: the
    state words, the header and the rows' valid flags, ts and kinds must
    agree.  Leaves the state restored."""
    outs = []
    for k in (kp, gkp):
        restore()
        kout = launch(k)[1]
        torch.cuda.synchronize()
        outs.append((state[0].clone(), state[1].clone(), kout))
    (a32, a64, ka), (b32, b64, kb) = outs
    if not (torch.equal(a32, b32) and torch.equal(a64, b64)):
        fail(f"{label}: the general mode's state differs from the flagship "
             f"mode's")
    v = ka[3]
    if not (torch.equal(ka[0], kb[0]) and torch.equal(v, kb[3]) and
            torch.equal(ka[1][v], kb[1][v]) and
            torch.equal(ka[2][v], kb[2][v])):
        fail(f"{label}: the general mode's header or rows differ from the "
             f"flagship mode's")
    restore()


def time_traffic(torch, ps, step, state, cols, wire, sel, now, gkp=None):
    """Kernel, kernel + projection and plain step at one send's inputs on
    a state whose Kb-key blocks are all alike: each timed call is a dense
    step on the next block, from the same restored state.  With `gkp`
    (the general mode's plan for the same query) also the general mode,
    held equal to the flagship mode and timed the same way.  Returns the
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
    if gkp is not None:
        same_launch(torch, restore, state, lambda k: ps.launch(
            k, state, cols, None, wire, sel, 0, now, True), kp, gkp,
            "flagship traffic")
        res["gen_ms"] = timed(torch, restore, lambda j: ps.launch(
            gkp, state, cols, None, wire, sel, j * Kb, now, True), 6, per)
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
    if [int(x) for x in hdr[:2]] != [BATCH, 0]:
        fail(f"flagship block step header {[int(x) for x in hdr]}")
    replicate_block(flag_state, BATCH)
    gkp = general_plans(dev, ql, "flagship", T)[0]
    flag = time_traffic(torch, ps, step, flag_state, cols, (1010, delta),
                        sel, 1013, gkp)
    del flag_state
    # seeded random traffic, from the state the comparison left
    replicate_block(kern_state, BATCH)
    rcols, wire, _, rsel, _, now = random_step_inputs(
        rng, torch, dev, planned.in_schemas[T].types, N_KEYS, BATCH, 4, True)
    rand = time_traffic(torch, ps, step, kern_state, rcols, wire, rsel, now,
                        gkp)
    del kern_state
    for name, t in (("flagship traffic", flag), ("random traffic", rand)):
        print(f"timing ({name}, dense step, 2^20-key state, {BATCH} keys x "
              f"4 events): kernel {t['ms']:.4f} ms/send, kernel+projection "
              f"{t['step_ms']:.4f} ms/send, plain torch step "
              f"{t['plain_ms']:.4f} ms/send, bound {t['bound_ms']:.4f} ms "
              f"by {t['bound_by']} ({t['bytes']} bytes, {t['ops']} ops); "
              f"the general mode on the same plan {t['gen_ms']:.4f} ms/send")
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
    records += join_phases(torch, np, dev)
    records += pattern_phases(torch, np, dev)
    records += table_phases(torch, np, dev)
    records += partition_phases(torch, np, dev)
    records += slice7_phases(torch, np, dev)
    records += slice8_phases(torch, np, dev)
    records += slice9_phases(torch, np, dev)
    records += slice10_phases(torch, np, dev)
    records += slice11_phases(torch, np, dev)
    records += slice12_phases(torch, np, dev)
    records += slice13_phases(torch, np, dev)
    records += slice14_phases(torch, np, dev)
    records += slice15_phases(torch, np, dev)
    records += slice16_phases(torch, np, dev)
    records += slice17_phases(torch, np, dev)

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


def drive(torch, np, rt, qname, stream, sends, warm, mods, last=None,
          timed=TIMED):
    """`warm` untimed sends, `timed` timed ones, then the rest untimed;
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
    wall = None
    for i, (cols, ts) in enumerate(sends):
        if i == warm:
            rt.flush()
            t_start = time.perf_counter()
        if i == warm + timed:
            rt.flush()
            wall = time.perf_counter() - t_start
        if last is not None:
            last(i)
        counts.append([0, 0])
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if warm <= i < warm + timed:
            lat.append(time.perf_counter() - tb)
    rt.flush()
    if wall is None:
        wall = time.perf_counter() - t_start
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


# ---------------------------------------------------------------------------
# stream-stream joins: kernels K5-K7 (length_window, join_lanes,
# join_probe) and the join path through SiddhiManager (J1-J3)
# ---------------------------------------------------------------------------

J1_B, J1_SYM, J1_TIMED = 1 << 13, 64, 16
J2_B, J2_IDS, J2_FILL, J2_TIMED = 1 << 17, 1 << 20, 8, 32
J3_B, J3_KEYS, J3_SENDS = 1 << 14, 256, 16


def join_modules():
    from siddhi_tpu_torch.kernels import filter_compact, join_lanes, \
        join_probe, length_window, time_window
    return {"filter_compact": filter_compact, "time_window": time_window,
            "length_window": length_window, "join_lanes": join_lanes,
            "join_probe": join_probe}


def stage(np, ev, cols, ts, kind=0):
    """A send staged as the runtime stages it: padded to its bucket."""
    n = len(cols[0])
    cap = ev.bucket_size(max(n, 1))

    def pad(a, d):
        out = np.zeros(cap, d)
        out[:n] = a
        return out
    return ev.StagedBatch(pad(ts, np.int64), pad(np.full(n, kind), np.int32),
                          pad(np.ones(n, np.bool_), np.bool_),
                          [pad(c, np.asarray(c).dtype) for c in cols], n)


def ring_state_err(torch, a, b, what):
    """Two rings (length or time) hold the same live rows and counters."""
    err = float_err(torch, a.meta[:3], b.meta[:3], f"{what} meta")
    pos = a.live()[3]
    for x, y in ((a.ts, b.ts), (a.gslot, b.gslot), *zip(a.cols, b.cols)):
        err = max(err, float_err(torch, x[pos], y[pos], f"{what} ring"))
    return err


def join_pair_step(torch, np, qr, is_left, staged, now, ka, kb, stats):
    """One side step with every kernel on state `ka` and every plain
    version on `kb` (equal before the step), each stage compared: K1's
    arrivals, the window's rows and ring (K5 or K2), the other side's lane
    table (K6), the probe's index rows and header (K7).  Returns the
    largest float difference (0: equal) and the step's inputs for
    timing."""
    from siddhi_tpu_torch.core import join as jn
    from siddhi_tpu_torch.core import event as ev
    m = join_modules()
    fc, lw, tw, jl, jp = (m[k] for k in ("filter_compact", "length_window",
                                         "time_window", "join_lanes",
                                         "join_probe"))
    p = qr.planned
    dev = p.device
    side, other = (p.left, p.right) if is_left else (p.right, p.left)
    spec = p.probe_specs[0 if is_left else 1]
    i, o = (0, 1) if is_left else (1, 0)
    batch = staged.to_device(side.schema, dev)
    B = staged.ts.shape[0]
    gslot = torch.zeros(B, dtype=torch.int32, device=dev)
    cols = tuple(batch.cols)
    if p.fastpath == "bucket":
        probe = qr._join_key_probe(is_left, staged)
        cols += (torch.from_numpy(probe).to(dev),)
    ra, ca = fc.launch(side.fspec, batch.ts, batch.kind, batch.valid, gslot,
                       cols)
    arr, na = fc.plain(side.fspec, batch.ts, batch.kind, batch.valid, gslot,
                       cols, now)
    torch.cuda.synchronize()
    err = max(rows_err(torch, ra, arr, "K1 (join side)", full=True),
              float_err(torch, ca, na, "K1 count"))
    if side.window.name == "length":
        wa = lw.launch(ka[i], arr, na)
        wb = lw.plain(kb[i], arr, na)
        wake = None
    else:
        cur = staged.ts[staged.valid & (staged.kind == 0)]
        f = ka[i].facts
        eb = f.expire_bound(now)
        kb[i].facts.expire_bound(now)
        cap_out = eb + cur.shape[0]
        a_sorted = cur.shape[0] < 2 or bool(np.all(cur[1:] >= cur[:-1]))
        t = side.window.time_ms
        wa, wake = tw.launch(ka[i], arr, na, now, t, B, cap_out, eb,
                             f.sorted, a_sorted)
        wb, wake_b = tw.plain(kb[i], arr, na, now, t, B, cap_out, eb)
        ka[i].facts.after_step(cur, now, t)
        kb[i].facts.after_step(cur, now, t)
        torch.cuda.synchronize()
        err = max(err, float_err(torch, wake, wake_b, "K2 wake (join)"))
    torch.cuda.synchronize()
    wname = "K5" if side.window.name == "length" else "K2"
    err = max(err, rows_err(torch, wa, wb, f"{wname} rows"),
              ring_state_err(torch, ka[i], kb[i], f"{wname} ring"))
    stats["steps"] += 1
    if spec is None:
        return err, None
    trig = wb
    nbl = (p.lane_buckets[o]) if p.fastpath == "bucket" else 0
    R = jn._reference_rows(side.window, B)
    Q = p.lane_k if p.fastpath == "bucket" else jn._retention_rows(
        other.window)
    N = R * Q + (R if spec.emit_unmatched else 0)
    cap = min(N, p.compact_rows if p.compact_rows is not None
              else max(2 * R, 1024))
    la = lb = None
    if p.fastpath == "bucket":
        oa = torch.zeros(1, dtype=torch.int64, device=dev)
        ob = torch.zeros(1, dtype=torch.int64, device=dev)
        la = jl.launch(ka[o].cols[-1], ka[o].meta, nbl, p.lane_k, oa)
        lb = jl.plain(kb[o].cols[-1], kb[o].meta, nbl, p.lane_k, ob)
        torch.cuda.synchronize()
        err = max(err, float_err(torch, la, lb, "K6 lanes"),
                  float_err(torch, oa, ob, "K6 overflow"))
        if int(oa):
            fail(f"K6: {int(oa)} rows past the lane width on the main path")
        stats["lanes"] += 1
    if trig.ts.shape[0] == 0:
        return err, None
    ha = torch.zeros(3, dtype=torch.int64, device=dev)
    hb = torch.zeros(3, dtype=torch.int64, device=dev)
    outa = jp.launch(spec, trig, ka[o].cols, ka[o].meta, la, nbl, cap, ha)
    outb = jp.plain(spec, trig, kb[o].cols, kb[o].meta, lb, nbl, cap, hb)
    torch.cuda.synchronize()
    for what, x, y in zip(("li", "ri", "null", "valid"), outa, outb):
        err = max(err, float_err(torch, x, y, f"K7 {what}"))
    err = max(err, float_err(torch, ha, hb, "K7 header"))
    stats["probes"] += 1
    stats["rows"] += int(ha[0])
    # the other ring as this probe saw it: a later step of the other side
    # moves it in place, and a probe timed against the moved ring would
    # find other rows than the lanes name
    return err, {"spec": spec, "trig": trig, "o": kb[o].clone(),
                 "lanes": lb, "hdr": hb.clone(),
                 "nbl": nbl, "cap": cap, "arr": arr, "na": na, "ring": kb[i],
                 "side": side}


def shadow_run(torch, np, rt, qname, sends, stats, timers=()):
    """A join's sends through join_pair_step from two equal empty states;
    `timers` = {send index: TIMER time} runs a TIMER step on every time
    side before that send.  Returns (largest difference, the last probe's
    inputs per side)."""
    from siddhi_tpu_torch.core import event as ev
    qr = rt.query_runtimes[qname]
    p = qr.planned
    ka = p.init_state()
    kb = tuple(r.clone() for r in ka)
    err, last = 0.0, {}
    for n, (stream, cols, ts) in enumerate(sends):
        if n in timers:
            for is_left, side in ((True, p.left), (False, p.right)):
                if side.window.needs_timer:
                    tst = stage(np, ev, [np.zeros(1, d) for d in
                                         (ev.np_dtype(t) for t in
                                          side.schema.types)],
                                np.full(1, timers[n]), kind=ev.TIMER)
                    e, _ = join_pair_step(torch, np, qr, is_left, tst,
                                          timers[n], ka, kb, stats)
                    err = max(err, e)
        is_left = stream == p.left.stream_id
        staged = stage(np, ev, cols, ts)
        e, info = join_pair_step(torch, np, qr, is_left, staged,
                                 int(np.max(ts)), ka, kb, stats)
        err = max(err, e)
        if info is not None:
            last[is_left] = info
    return err, last


def j1_sends(np, rng, n):
    """bench.py config_windowed_join: 8192 events a side a send, 64
    symbols, ts = 1000 + i on both sides."""
    out = []
    for i in range(n):
        ts = np.full(J1_B, 1000 + i, np.int64)
        out.append(("L", [rng.integers(0, J1_SYM, J1_B).astype(np.int64),
                          rng.random(J1_B, np.float32)], ts))
        out.append(("R", [rng.integers(0, J1_SYM, J1_B).astype(np.int64),
                          rng.integers(1, 9, J1_B).astype(np.int32)], ts))
    return out


def j2_sends(np, rng, n, first=0):
    """The enrichment join: 131,072 Orders then 131,072 Fills a send, ids
    uniform over 2^20, ts = 1000 + 10 i on both sides."""
    out = []
    for i in range(first, first + n):
        ts = np.full(J2_B, 1000 + 10 * i, np.int64)
        out.append(("Orders", [rng.integers(0, J2_IDS, J2_B).astype(np.int64),
                               rng.random(J2_B, dtype=np.float32)], ts))
        out.append(("Fills", [rng.integers(0, J2_IDS, J2_B).astype(np.int64),
                              rng.integers(1, 9, J2_B).astype(np.int32)], ts))
    return out


def compare_join_kernels(torch, np, dev):
    """K5, K6 and K7 (with K1 and K2 on the join sides) against their plain
    versions, stage by stage: J1's and J2's shapes, small joins (outer,
    grid, time sides with TIMER steps, having, a batch longer than its
    window), and a forced lane overflow.  Returns the largest difference,
    the probe inputs of J1 and J2 for timing, and counts."""
    from siddhi_tpu_torch import SiddhiManager
    m = join_modules()
    stats = {"steps": 0, "lanes": 0, "probes": 0, "rows": 0}
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(J1_QL)
    err, j1_last = shadow_run(torch, np, rt, "q",
                              j1_sends(np, np.random.default_rng(41), 2),
                              stats)
    print(f"compare: J1's shape (length(128) sides, {J1_B} rows a side, "
          f"the bucket path, lane width "
          f"{rt.query_runtimes['q'].planned.lane_k}): kernels == plain")
    # a forced lane overflow on J1's ring: both versions report it
    o = j1_last[True]["o"]
    js = o.cols[-1]
    oa = torch.zeros(1, dtype=torch.int64, device=dev)
    ob = torch.zeros(1, dtype=torch.int64, device=dev)
    la = m["join_lanes"].launch(js, o.meta, 256, 1, oa)
    lb = m["join_lanes"].plain(js, o.meta, 256, 1, ob)
    torch.cuda.synchronize()
    err = max(err, float_err(torch, la, lb, "K6 forced overflow lanes"),
              float_err(torch, oa, ob, "K6 forced overflow count"))
    live = int(o.meta[1] - o.meta[0])
    want = int(np.maximum(np.bincount(
        (js[o.live()[3]].cpu().numpy() % 256), minlength=256) - 1, 0).sum())
    if int(oa) <= 0 or int(oa) != want:
        fail(f"K6 forced overflow: reported {int(oa)}, numpy {want}")
    print(f"compare: join_lanes with lane width 1 on J1's ring ({live} "
          f"rows): both versions report {int(oa)} rows past the lane "
          f"(numpy recount {want})")
    # small joins: outer / grid / time sides with TIMER steps / having /
    # a batch longer than its window
    rng = np.random.default_rng(42)
    for what, ql, timers in SMALL_JOINS:
        srt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
        sends = []
        for i in range(6):
            B = [16, 300, 2048][i % 3]
            ts = 1000 + 700 * i + np.sort(rng.integers(0, 50, B))
            sends.append(("L", [rng.integers(0, 40, B).astype(np.int64),
                                rng.random(B, np.float32),
                                rng.random(B) < 0.5], ts))
            sends.append(("R", [rng.integers(0, 40, B).astype(np.int64),
                                rng.integers(1, 9, B).astype(np.int32)],
                          ts + 3))
        e, _ = shadow_run(torch, np, srt, "q", sends, stats, timers)
        err = max(err, e)
        p = srt.query_runtimes["q"].planned
        print(f"compare: small join ({what}; path {p.fastpath or 'grid'}): "
              f"kernels == plain")
    # J2's shape: the windows fill over 8 sends, the 9th is steady
    rt2 = mgr.create_siddhi_app_runtime(J2_QL)
    e, j2_last = shadow_run(torch, np, rt2, "enrich",
                            j2_sends(np, np.random.default_rng(43),
                                     J2_FILL + 1), stats)
    err = max(err, e)
    p2 = rt2.query_runtimes["enrich"].planned
    print(f"compare: J2's shape (length({p2.ring_caps[0]}) sides, {J2_B} "
          f"rows a side, {p2.lane_buckets[0]} lane buckets, lane width "
          f"{p2.lane_k}): kernels == plain")
    print(f"compare: K5-K7 == plain over {stats['steps']} window steps, "
          f"{stats['lanes']} lane tables, {stats['probes']} probes "
          f"({stats['rows']} joined rows), max_abs_err {err}")
    mgr.shutdown()
    return err, j1_last, j2_last


class JoinRecount:
    """numpy's view of two length windows and of what each step must emit:
    per trigger row (EXPIRED k before CURRENT k, as the window emits them)
    the number of equal-id rows on the other side, the pairs, the
    unmatched rows of an outer side, the cut to the cap and the CURRENT
    rows inside it."""

    def __init__(self, np, C, outer_left, outer_right, explicit_cap=None):
        self.np, self.C = np, C
        self.win = {True: np.zeros(0, np.int64), False: np.zeros(0, np.int64)}
        self.aux = {True: np.zeros(0), False: np.zeros(0)}
        self.outer = {True: outer_left, False: outer_right}
        self.cap = explicit_cap

    def step(self, is_left, ids, aux, B):
        np = self.np
        w, a = self.win[is_left], self.aux[is_left]
        C = self.C
        count0, n = w.shape[0], ids.shape[0]
        k0 = max(0, C - count0)
        virt = np.concatenate([w, ids])
        vaux = np.concatenate([a, aux])
        k = np.arange(n)
        ek = k[k >= k0]
        trig = np.empty(n + ek.shape[0], np.int64)
        kind = np.zeros(trig.shape[0], np.int32)
        taux = np.empty(trig.shape[0], vaux.dtype)
        cpos = np.where(k < k0, k, k0 + 2 * (k - k0) + 1)
        epos = k0 + 2 * (ek - k0)
        trig[cpos], taux[cpos] = ids, aux
        trig[epos], taux[epos] = virt[count0 + ek - C], vaux[count0 + ek - C]
        kind[epos] = 1
        other = self.win[not is_left]
        self.win[is_left], self.aux[is_left] = virt[-C:], vaux[-C:]
        srt = np.sort(other)
        cnt = (np.searchsorted(srt, trig, "right") -
               np.searchsorted(srt, trig, "left"))
        pairs = int(cnt.sum())
        un = (cnt == 0) if self.outer[is_left] else np.zeros_like(cnt, bool)
        total = pairs + int(un.sum())
        R = 2 * B
        cap = self.cap if self.cap is not None else max(2 * R, 1024)
        start = np.cumsum(cnt) - cnt
        kept = np.clip(cap - start, 0, cnt)
        rem = max(0, cap - pairs)
        un_cur = np.nonzero(un)[0][:rem]
        n_cur = int(kept[kind == 0].sum()) + int((kind[un_cur] == 0).sum())
        nv = min(total, cap)
        return {"n_valid": nv, "n_current": n_cur, "n_dropped": total - nv,
                "pairs": pairs, "unmatched": int(un.sum()), "trig": trig,
                "taux": taux, "cnt": cnt, "kind": kind}


def drive_join(torch, np, rt, qname, sends, warm, timed, mods, recount,
               checks=None, keep=()):
    """Sends through the runtime: `warm` untimed, `timed` timed, the rest
    untimed, each send one batch per side.  Afterwards (outside the
    timing) every step's header counts are held to the numpy recount, and
    `checks(i, step, payload)` runs with the payloads of the steps in
    `keep`.  Counts of every kernel and plain version from just before the
    first send to just after the last."""
    got = []
    rt.add_batch_callback(qname, lambda ts, b: got.append(b))
    for mo in mods.values():
        mo.reset_counts()
    p = rt.query_runtimes[qname].planned
    lat, wall, t0 = [], 0.0, None
    heads, kept = [], {}
    for i, (stream, cols, ts) in enumerate(sends):
        if i == 2 * warm:
            rt.flush()
            t0 = time.perf_counter()
        if i == 2 * (warm + timed) and timed:
            rt.flush()
            wall = time.perf_counter() - t0
        n0 = len(got)
        tb = time.perf_counter()
        rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
        if 2 * warm <= i < 2 * (warm + timed):
            if stream == p.left.stream_id:
                lat.append(time.perf_counter() - tb)
            else:
                lat[-1] += time.perf_counter() - tb
        b = got[n0] if len(got) > n0 else None
        heads.append((b["n_valid"], b["n_current"], b["n_dropped"])
                     if b is not None else (0, 0, 0))
        if i in keep:
            kept[i] = b
        got.clear()
    rt.flush()
    if timed and wall == 0.0:       # the timed sends were the last ones
        wall = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    for i, (stream, cols, ts) in enumerate(sends):
        want = recount.step(stream == p.left.stream_id,
                            cols[0].astype(np.int64), cols[1], len(cols[0]))
        if heads[i] != (want["n_valid"], want["n_current"],
                        want["n_dropped"]):
            fail(f"{qname} send {i // 2} ({stream}): header {heads[i]}, "
                 f"numpy recount ({want['n_valid']}, {want['n_current']}, "
                 f"{want['n_dropped']})")
        if checks is not None:
            checks(i, want, kept.get(i))
    return lat, wall, launches, plain


def run_j1(torch, np, dev, mods):
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(J1_QL)
    rt.start()
    rec = JoinRecount(np, 128, False, False, explicit_cap=65536)
    lat, wall, launches, plain = drive_join(
        torch, np, rt, "q", j1_sends(np, np.random.default_rng(3),
                                     1 + J1_TIMED), 1, J1_TIMED, mods, rec)
    p = rt.query_runtimes["q"].planned
    check_launched("J1", launches, plain, ("filter_compact", "length_window",
                                          "join_lanes", "join_probe"))
    print(f"J1 plan: path {p.fastpath}, lane buckets {p.lane_buckets}, lane "
          f"width {p.lane_k}; every step's [n_valid, n_current, n_dropped] "
          f"equals the numpy recount")
    h2d = 2 * J1_B * (8 + 4 + 1 + 8 + 4 + 4) + 2 * 48
    lat_line(np, "J1 (bench.py windowed join)", lat, wall,
             2 * J1_B * J1_TIMED, h2d)
    mgr.shutdown()
    return launches


def run_j2(torch, np, dev, mods):
    """The enrichment join at full size: 8 sends fill both 2^20-row
    windows, 32 timed sends, one more whose Orders rows are fetched and
    held in full to numpy, then a profiled sweep."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(J2_QL)
    rt.start()
    rec = JoinRecount(np, J2_IDS, True, False)
    rng = np.random.default_rng(5)
    n_sends = J2_FILL + J2_TIMED + 1
    sends = j2_sends(np, rng, n_sends)
    full = {}

    def checks(i, want, b):
        if b is None:                      # the last Orders step is kept
            return
        v = b["valid"]
        cols = {k: np.asarray(c)[v] for k, c in b["cols"].items()}
        full["got"] = cols
        full["want"] = want
        full["fills"] = (rec.win[False].copy(), rec.aux[False].copy())
    qr = rt.query_runtimes["enrich"]
    track, spent = qr._jk.track, [0.0, 0]

    def timed_track(*a):
        t = time.perf_counter()
        out = track(*a)
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return out
    qr._jk.track = timed_track
    lat, wall, launches, plain = drive_join(
        torch, np, rt, "enrich", sends, J2_FILL, J2_TIMED, mods, rec,
        checks, keep={2 * (n_sends - 1)})
    p = qr.planned
    check_launched("J2", launches, plain, ("filter_compact", "length_window",
                                          "join_lanes", "join_probe"))
    # the full check: the multiset of (id, price, qty) of the last Orders
    # step against numpy (pairs: the trigger row's price with each equal-id
    # Fills row's qty; unmatched rows: qty null)
    want = full["want"]
    fids, fqty = full["fills"]
    order = np.argsort(fids, kind="stable")
    fs, fq = fids[order], fqty[order]
    lo = np.searchsorted(fs, want["trig"], "left")
    cnt = want["cnt"]
    rep = np.repeat(np.arange(want["trig"].shape[0]), cnt)
    within = np.arange(rep.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    w_id = np.concatenate([want["trig"][rep], want["trig"][cnt == 0]])
    w_price = np.concatenate([want["taux"][rep], want["taux"][cnt == 0]])
    w_qty = np.concatenate([fq[lo[rep] + within].astype(np.int32),
                            np.full(int((cnt == 0).sum()),
                                    np.iinfo(np.int32).min, np.int32)])
    got = full["got"]

    def key(i, pr, q):
        return np.sort(np.rec.fromarrays(
            [i.astype(np.int64), pr.astype(np.float32).view(np.int32),
             q.astype(np.int32)]), order=["f0", "f1", "f2"])
    if not np.array_equal(key(w_id, w_price, w_qty),
                          key(got["id"], got["price"], got["qty"])):
        fail("J2: the last Orders step's rows are not numpy's (id, price, "
             "qty) multiset")
    print(f"J2 check: every step's [n_valid, n_current, n_dropped] equals "
          f"the numpy recount; the last Orders step's {got['id'].shape[0]} "
          f"rows ({want['pairs']} pairs, {want['unmatched']} with a null "
          f"qty) equal numpy's (id, price, qty) multiset; path "
          f"{p.fastpath}, lane buckets {p.lane_buckets[0]}, lane width the "
          f"tracker chose {p.lane_k}, emission cap "
          f"{p.compact_rows or max(4 * J2_B, 1024)} (implicit: max(2R, "
          f"1024), R = 2B)")
    h2d = 2 * J2_B * (8 + 4 + 1 + 8 + 4 + 4) + 2 * 48
    lat_line(np, "J2 (enrichment join, 2^20-row windows)", lat, wall,
             2 * J2_B * J2_TIMED, h2d)
    per_step = spent[0] * 1e3 / max(spent[1], 1)
    p50 = float(np.percentile(np.array(lat) * 1e3, 50))
    print(f"J2 host: JoinKeyTracker.track (numpy and Python, copied from "
          f"the reference) {per_step:.3f} ms a step over all {spent[1]} "
          f"steps, {2 * per_step:.3f} ms a send against the per-send p50 "
          f"{p50:.3f} ms")
    extra = j2_sends(np, rng, 8, first=n_sends)

    def send(b):
        for stream, cols, ts in extra[2 * b:2 * b + 2]:
            rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
    qr.batch_callbacks.clear()
    rt.add_batch_callback("enrich", lambda ts, b: None)
    profile = device_profile(torch, rt, 8, send)
    if profile["device_ms"] is None:
        print(f"profile (J2, 8 more sends): wall {profile['wall_ms']:.3f} "
              f"ms, device time not measured")
    else:
        print(f"profile (J2, 8 more sends): wall {profile['wall_ms']:.3f} "
              f"ms, device busy {profile['device_ms']:.3f} ms (idle share "
              f"{profile['idle_share']:.4f}); top device ops: "
              + "; ".join(f"{n} {t:.3f} ms over {c} calls"
                          for n, t, c in profile["top"]))
    mgr.shutdown()
    return launches


def run_j3(torch, np, dev, mods):
    """The two join samples, whole: 16,384 events a side a send, keys
    uniform over 0..255, 16 sends; header counts held to the numpy
    recount, and the outer-join sample's second query (coalesce over the
    join's output, null rows included) counted against numpy."""
    from siddhi_tpu_torch import SiddhiManager
    total = {k: 0 for k in mods}
    rng = np.random.default_rng(6)
    for name, qname, C, outer, mk in (
            ("join_streams.siddhi", "joinQuery", 10, False,
             lambda B: (rng.random(B) * 40).astype(np.float32)),
            ("outer_join_enrichment.siddhi", "enrich", 32, True,
             lambda B: (rng.random(B) * 100).astype(np.float32))):
        with open(f"samples/apps/{name}") as fh:
            ql = fh.read()
        mgr = SiddhiManager()
        rt = mgr.create_siddhi_app_runtime(ql)
        p = rt.query_runtimes[qname].planned
        ls, rs = p.left.stream_id, p.right.stream_id
        sends = []
        for i in range(J3_SENDS):
            ts = np.full(J3_B, 1000 + i, np.int64)
            sends.append((ls, [rng.integers(0, J3_KEYS, J3_B).astype(
                np.int32), mk(J3_B)], ts))
            rb = rng.random(J3_B) < 0.5 if rs == "RegulatorStream" else \
                rng.integers(1, 9, J3_B).astype(np.int32)
            sends.append((rs, [rng.integers(0, J3_KEYS, J3_B).astype(
                np.int32), rb], ts))
        big = [0]
        want_big = [0]
        if qname == "enrich":
            rt.add_batch_callback("bigFills", lambda ts, b: big.__setitem__(
                0, big[0] + b["n_current"]))
        rec = JoinRecount(np, C, outer, False)

        def checks(i, want, b, _rec=rec):
            if qname != "enrich":
                return
            # bigFills counts joined CURRENT rows whose qty > 5
            is_left = i % 2 == 0
            cur = want["kind"] == 0
            if is_left:
                fids, fq = _rec.win[False], _rec.aux[False]
                fsel = np.sort(fids[fq > 5])
                c5 = (np.searchsorted(fsel, want["trig"], "right") -
                      np.searchsorted(fsel, want["trig"], "left"))
                want_big[0] += int(c5[cur].sum())
            else:
                want_big[0] += int(want["cnt"][cur & (want["taux"] > 5)]
                                   .sum())
        rt.start()
        _, _, launches, plain = drive_join(torch, np, rt, qname, sends, 0, 0,
                                           mods, rec, checks)
        check_launched(f"J3 {name}", launches, plain,
                       ("filter_compact", "length_window", "join_lanes",
                        "join_probe"))
        if qname == "enrich" and big[0] != want_big[0]:
            fail(f"J3 {name}: bigFills delivered {big[0]} rows, numpy "
                 f"{want_big[0]}")
        print(f"J3 {name}: {J3_SENDS} sends of {J3_B} events a side; every "
              f"step's header equals the numpy recount"
              + (f"; bigFills (coalesce(qty, 0) > 5 over the join's "
                 f"output) delivered {big[0]} rows, numpy {want_big[0]}"
                 if qname == "enrich" else ""))
        for k, v in launches.items():
            total[k] += v
        mgr.shutdown()
    return total


def time_join_kernels(torch, np, dev, last, label):
    """K5, K6 and K7 per launch at one configuration's shapes (the last
    probe inputs of the comparison run), CUDA-graph replays between CUDA
    events, beside their plain versions and the bound of the bytes the
    inputs need."""
    m = join_modules()
    lw, jl, jp = m["length_window"], m["join_lanes"], m["join_probe"]
    info = last[True]
    res = {}
    ring, arr, na = info["ring"], info["arr"], info["na"]
    meta0 = ring.meta.clone()

    def restore():
        ring.meta.copy_(meta0)
    # K5: from the restored counters (the arrivals overwrite the rows they
    # evict, so each replay does the same work)
    C = ring.C
    n = int(na)
    B = arr.ts.shape[0]
    count0 = int(meta0[1] - meta0[0])
    e = max(0, n - max(0, C - count0))
    cb = col_bytes(arr.cols)
    res["length_window"] = {
        "ms": graph_ms(torch, lambda: lw.launch(ring, arr, na), 20, restore),
        "plain_ms": event_timer(torch, lambda: lw.plain(ring, arr, na), 3,
                                restore),
        **bound(n * (12 + cb) + (n + e) * (ROW_OUT + cb) + e * (12 + cb) +
                min(n, C) * (12 + cb) + (2 * B - n - e) + 64)}
    restore()
    o, spec = info["o"], info["spec"]
    nbl, cap, trig = info["nbl"], info["cap"], info["trig"]
    ov = torch.zeros(1, dtype=torch.int64, device=dev)
    live = int(o.meta[1] - o.meta[0])
    k = info["lanes"].shape[1]
    res["join_lanes"] = {
        "ms": graph_ms(torch, lambda: jl.launch(o.cols[-1], o.meta, nbl, k,
                                                ov), 20),
        "plain_ms": event_timer(torch, lambda: jl.plain(o.cols[-1], o.meta,
                                                        nbl, k, ov), 3),
        **bound(4 * live + 4 * nbl * k + 8 + 32)}
    lanes = info["lanes"]
    hd = torch.zeros(3, dtype=torch.int64, device=dev)
    # what the probe must read: the trigger rows (kind, valid, the columns
    # the ON reads, the key slot); of each lane its trigger rows touch, the
    # occupied entries and the empty one that ends the walk, in 32-byte
    # sectors; the other ring's columns the ON reads, once for each row in
    # those lanes.  What it must write: n_valid index rows (li, ri, null,
    # valid), the valid flag of the rows past them, the header.
    data = trig.valid & ((trig.kind == 0) | (trig.kind == 1))
    R = int(data.sum())
    buckets = torch.unique(torch.remainder(
        trig.cols[-1][data].to(torch.int64), nbl))
    touched = int(buckets.shape[0])
    occ = (lanes[buckets] < o.C).sum(dim=1)
    lane_bytes = int(torch.minimum(
        torch.div(torch.minimum(occ + 1, torch.full_like(occ, k)) * 4 + 31,
                  32, rounding_mode="floor") * 32,
        torch.full_like(occ, k * 4)).sum())
    from siddhi_tpu_torch.kernels.filter_bytecode import LOAD_EV, LOAD_OTHER
    code = spec.on_code
    ev_cols = {code[j + 1] for j in range(len(code) - 1)
               if code[j] == LOAD_EV}
    ot_cols = {code[j + 1] for j in range(len(code) - 1)
               if code[j] == LOAD_OTHER}
    t_bytes = sum(trig.cols[c].element_size() for c in ev_cols)
    o_bytes = sum(o.cols[c].element_size() for c in ot_cols)
    cand = int((lanes[torch.remainder(trig.cols[-1][data].to(torch.int64),
                                      nbl)] < o.C).sum())
    jp.launch(spec, trig, o.cols, o.meta, lanes, nbl, cap, hd)
    if hd.tolist() != info["hdr"].tolist():
        fail(f"join_probe ({label}): the timed inputs give header "
             f"{hd.tolist()}, the compared step {info['hdr'].tolist()}")
    n_valid = int(hd[0])
    res["join_probe"] = {
        "ms": graph_ms(torch, lambda: jp.launch(spec, trig, o.cols, o.meta,
                                                lanes, nbl, cap, hd), 20),
        "plain_ms": event_timer(torch, lambda: jp.plain(
            spec, trig, o.cols, o.meta, lanes, nbl, cap, hd), 3),
        **bound(R * (4 + 1 + 4 + t_bytes) + lane_bytes +
                int(occ.sum()) * o_bytes + n_valid * 10 + (cap - n_valid) +
                24, cand * len(code))}
    for kname, t in res.items():
        print(f"timing {kname} ({label}): kernel {t['ms']:.4f} ms/launch, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"by {t['bound_by']} ({t['bytes']} bytes, {t['ops']} ops)")
    print(f"timing join_probe ({label}): {R} trigger rows, {cand} "
          f"candidates, {touched} lane buckets touched ({lane_bytes} lane "
          f"bytes, {int(occ.sum())} ring rows in them), n_valid {n_valid} "
          f"of cap {cap}")
    return res


def join_phases(torch, np, dev):
    """Phases 10-13: K5-K7 against their plain versions, J1-J3 through
    SiddhiManager with their recounts, per-kernel times at J1's and J2's
    shapes.  Returns the three kernel records."""
    mods = join_modules()
    err, j1_last, j2_last = compare_join_kernels(torch, np, dev)
    t1 = time_join_kernels(torch, np, dev, j1_last, "J1's shape")
    t2 = time_join_kernels(torch, np, dev, j2_last, "J2's shape")
    del j1_last, j2_last
    torch.cuda.empty_cache()
    launches = {k: 0 for k in mods}
    for run in (run_j1, run_j2, run_j3):
        for k, v in run(torch, np, dev, mods).items():
            launches[k] += v
    torch.cuda.empty_cache()
    reasons = {
        "length_window": "no single torch call runs a sliding window's "
                         "eviction and append",
        "join_lanes": "torch.sort gives the bucket order but not the "
                      "[buckets, width] table with its overflow count",
        "join_probe": "no single torch call probes candidate lanes with a "
                      "bytecode condition and compacts pairs and unmatched "
                      "rows"}
    records = []
    for k, src, rep in (
            ("length_window", "length_window.cu",
             "siddhi_tpu/core/window.py:249"),
            ("join_lanes", "join_lanes.cu", "siddhi_tpu/core/join.py:775"),
            ("join_probe", "join_probe.cu", "siddhi_tpu/core/join.py:445")):
        print(f"kernel {k}: J1's shape {t1[k]['ms']:.4f} ms (bound "
              f"{t1[k]['bound_ms']:.5f}), J2's shape {t2[k]['ms']:.4f} ms "
              f"(bound {t2[k]['bound_ms']:.5f}), plain {t2[k]['plain_ms']:.4f}"
              f" ms at J2's shape, launches on the main path {launches[k]}; "
              f"library_ms null: {reasons[k]}")
        records.append({
            "name": k, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches[k], "max_abs_err": err, "ms": t2[k]["ms"],
            "plain_ms": t2[k]["plain_ms"], "bound_ms": t2[k]["bound_ms"],
            "bound_by": t2[k]["bound_by"], "library_ms": None})
    return records


# ---------------------------------------------------------------------------
# single-key patterns and sequences (K8 block_nfa) and absent patterns
# (pattern_step's absent atoms and timer mode)
# ---------------------------------------------------------------------------

S1_B = 1 << 11            # bench.py config_sequence_within's batch
S1W_B = 1 << 17           # S1-wide: the batch of the port's other paths
S2_B = 1 << 14            # the pattern sample's sends
S2_SYMS = 64
A1_KEYS = 1 << 20         # A1's partition keys
A1_BLOCK = 1 << 17        # A1's keys a send
NO_WAKE = (2 ** 63 - 1) // 4


def clone_state(state):
    b32, b64, scal = state
    return (b32.clone(), b64.clone(), tuple(s.clone() for s in scal))


def restore_into(dst, src):
    for a, b in zip(dst[:2], src[:2]):
        a.copy_(b)
    for a, b in zip(dst[2], src[2]):
        a.copy_(b)


def s1_send(np, rng, i, B):
    """One send of bench.py config_sequence_within: symbol 0, price
    uniform, volume alternating 1, 2, ts 1000 + 50 i + (j mod 50)."""
    return ([np.zeros(B, np.int64), rng.random(B, np.float32),
             np.tile(np.array([1, 2], np.int32), B // 2)],
            1000 + i * 50 + np.arange(B, dtype=np.int64) % 50)


def s1_matches(np, cols):
    """S1's closed form: each volume-1 event seeds, the next event (its
    volume-2 partner, always inside `within`) completes it iff its price
    is higher."""
    p = cols[1]
    return int(np.sum(p[1::2] > p[0::2]))


def s2_send(np, rng, i, B, sym_ids):
    return ([sym_ids[rng.integers(0, S2_SYMS, B)],
             rng.random(B, np.float32)],
            1000 + i * B + np.arange(B, dtype=np.int64))


def block_inputs(torch, np, dev, cols, ts, invalid=0.0, rng=None,
                 wire=True, sel=None):
    """Device arguments of one block step: the columns, the ts (as the
    ts-delta wire or the raw column), the [1, E] selection (a share of
    invalid rows, or `sel` as given), key_ref and now."""
    B = ts.shape[0]
    if sel is None:
        sel = np.arange(B, dtype=np.int32)
        if invalid:
            sel[rng.random(B) < invalid] = -1
    dcols = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                  for c in cols)
    if wire:
        ts_args = (int(ts[0]), torch.from_numpy(
            (ts - ts[0]).astype(np.int32)).to(dev))
    else:
        ts_args = (torch.from_numpy(ts).to(dev),)
    key = torch.zeros(1, dtype=torch.int32, device=dev)
    return (dcols,) + ts_args + (torch.from_numpy(sel[None, :]).to(dev),
                                 key, int(ts.max()))


def block_compare(torch, planned, sid, state, args, wire, what):
    """One block step through K8 and its plain version from copies of one
    state: state words, dropped, header, valid mask and the valid rows
    must be equal.  Returns (kernel state, max float err, header)."""
    steps = planned.steps_w if wire else planned.steps
    step = steps[sid]
    a = step.plain(clone_state(state), (), *args)
    b = step.kernel(state, (), *args)
    torch.cuda.synchronize()
    err, hdr = compare_steps(torch, a, b, what, False)
    print(f"compare: {what}: K8 == plain, header {hdr}, dropped "
          f"{int(b[0][2][0])}")
    return b[0], err, hdr


def bn_bound(planned, sid, E, n_rows, wire):
    """K8's bound: the bytes its inputs need (E events' selection, ts and
    columns), the rows it writes (ts, valid, emitted columns) and the slab
    read and written once."""
    schema = planned.in_schemas[sid]
    ev_bytes = sum(np_size(t) for t in schema.types) + 4 + (4 if wire else 8)
    kp = planned.steps[sid].kernel_plan
    row = 8 + 1 + sum(np_size(kp.sel.scope.schema(kp.atoms[a].ref).types[c])
                      for a, c in kp.emit)
    st = planned.init_state(1)[0]
    slab = st[0].numel() * 4 + st[1].numel() * 8 + 8
    return bound(E * ev_bytes + n_rows * row + 2 * slab)


def np_size(attr_type):
    return {"LONG": 8, "BOOL": 1}.get(attr_type.upper(), 4)


def compare_block_kernel(torch, np, dev):
    """K8 against its plain version stage by stage: S1's and S1-wide's
    shapes, S2's, a sequence without `every`, a slab of two slots that
    overflows at chunk boundaries, batches with invalid rows, raw-ts and
    ts-delta wires, and K8_EDGE_CASES (first matches past event 96 of a
    chunk, seeds that never match on falling prices, `within` cuts inside
    a chunk, runs of over 32 invalid rows in a sequence) at K8_EDGE_E
    events.  Returns (max err, steps compared, timing inputs)."""
    from siddhi_tpu_torch import SiddhiManager
    rng = np.random.default_rng(41)
    max_err, n = 0.0, 0
    timing = {}

    def run(ql, qname, sid, sends, label, wire=True, invalid=0.0,
            keep=None):
        nonlocal max_err, n
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
        planned = rt.query_runtimes[qname].planned
        if not planned.block:
            fail(f"{label}: not planned onto the block NFA")
        state = planned.init_state(1)[0]
        for i, (cols, ts, *sel) in enumerate(sends):
            args = block_inputs(torch, np, dev, cols, ts, invalid, rng, wire,
                                *sel)
            before = clone_state(state)
            state, err, hdr = block_compare(
                torch, planned, sid, state, args, wire,
                f"{label} step {i} (E={ts.shape[0]}, "
                f"{'ts-delta' if wire else 'raw-ts'})")
            max_err, n = max(max_err, err), n + 1
        if keep is not None:
            timing[keep] = (planned, sid, before, args, wire, hdr)

    run(S1_QL.format(rows=4096), "q", "S",
        [s1_send(np, rng, i, S1_B) for i in range(3)], "S1", keep="S1")
    run(S1_QL.format(rows=65536), "q", "S",
        [s1_send(np, rng, i, S1W_B) for i in range(2)], "S1-wide",
        keep="S1-wide")
    mgr = SiddhiManager(device=dev)
    with open("samples/apps/pattern_matching.siddhi") as fh:
        s2_ql = fh.read()
    ids = np.array([mgr.interner.intern(f"SYM{i}") for i in range(S2_SYMS)],
                   np.int32)
    run(s2_ql, "riseQuery", "StockStream",
        [s2_send(np, rng, i, S2_B, ids) for i in range(2)], "S2")

    def rand_sends(k, B):
        out = []
        for i in range(k):
            out.append(([np.zeros(B, np.int64), rng.random(B, np.float32),
                         rng.integers(1, 4, B).astype(np.int32)],
                        1000 + 200 * i +
                        np.sort(rng.integers(0, 150, B)).astype(np.int64)))
        return out
    run(NON_EVERY_SEQ_QL, "q", "S", rand_sends(2, S1_B), "non-every sequence",
        wire=False)
    run(OVERFLOW_QL, "q", "S", rand_sends(3, S1_B), "two-slot overflow")
    run(S1_QL.format(rows=4096), "q", "S",
        [s1_send(np, rng, i, S1_B) for i in range(2)], "invalid rows",
        invalid=0.1)
    for name, ql in K8_EDGE_CASES.items():
        for wire in (True, False):
            run(ql, "q", "S", [k8_edge_send(np, rng, name, K8_EDGE_E, i)
                               for i in range(2)], name, wire=wire)
    print(f"compare: K8 == plain over {n} block steps, max_abs_err "
          f"{max_err}")
    return max_err, n, timing


def time_block_kernel(torch, np, dev, timing, label):
    """K8 per launch at one shape (the last compared step's inputs, from
    its state), CUDA-graph replays between CUDA events, beside its plain
    version and its bound."""
    from siddhi_tpu_torch.kernels import block_nfa as bn
    planned, sid, before, args, wire, hdr = timing[label]
    kp = planned.steps[sid].kernel_plan
    state = clone_state(before)
    cols = args[0]
    if wire:
        ts_wire, raw_ts, sel, now = (args[1], args[2]), None, args[3], args[5]
    else:
        ts_wire, raw_ts, sel, now = None, args[1], args[2], args[4]

    def restore():
        restore_into(state, before)
    restore()
    kout = bn.launch(kp, state, cols, raw_ts, ts_wire, sel, now)[1]
    n_rows = int(kout[0][0])
    step = (planned.steps_w if wire else planned.steps)[sid]
    E = sel.shape[1]
    res = {"ms": graph_ms(torch, lambda: bn.launch(kp, state, cols, raw_ts,
                                                   ts_wire, sel, now), 10,
                          restore),
           "plain_ms": event_timer(torch, lambda: step.plain(
               state, (), *args), 2, restore),
           **bn_bound(planned, sid, E, n_rows, wire)}
    print(f"timing block_nfa ({label}: E={E}, {(E + 127) // 128} chunks, "
          f"{n_rows} completions): kernel {res['ms']:.4f} ms/launch, plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.5f} ms by "
          f"{res['bound_by']} ({res['bytes']} bytes)")
    return res


def a1_sends(np, i):
    """A1's send i: S1 rows (v = 1) for key block i mod 8 at
    1000 + 250 i, then S2 rows for that block's even keys 100 ms later."""
    blk = i % (A1_KEYS // A1_BLOCK)
    keys = np.arange(blk * A1_BLOCK, (blk + 1) * A1_BLOCK, dtype=np.int64)
    t1 = 1000 + 250 * i
    s1 = ([keys, np.ones(A1_BLOCK, np.int32)],
          np.full(A1_BLOCK, t1, np.int64))
    even = keys[0::2]
    s2 = ([even, np.full(even.shape[0], 2, np.int32)],
          np.full(even.shape[0], t1 + 100, np.int64))
    return s1, s2


def absent_step_args(torch, np, dev, planned, cols, ts, wire, dense):
    """Device arguments of one partitioned data step of A1's query from
    host columns: keys become slots in order (slot = key), one event each."""
    n = ts.shape[0]
    keys = cols[0]
    dcols = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                  for c in cols)
    sel = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    if dense:
        key_ref = int(keys[0])
    else:
        key_ref = torch.from_numpy(keys.astype(np.int32)).to(dev)
    if wire:
        ts_args = (int(ts[0]), torch.from_numpy(
            (ts - ts[0]).astype(np.int32)).to(dev))
    else:
        ts_args = (torch.from_numpy(ts).to(dev),)
    return (dcols,) + ts_args + (sel, key_ref, int(ts.max()))


def absent_compare(torch, a, b, what, compact):
    err, hdr = compare_steps(torch, a, b, what, compact)
    wa, wb = int(a[3]), int(b[3])
    if wa != wb:
        fail(f"{what}: wake {wa} != {wb}")
    print(f"compare: {what}: pattern_step == plain, header {hdr}, wake "
          f"{wa if wa < NO_WAKE else 'none'}")
    return err


def compare_absent_kernel(torch, np, dev):
    """pattern_step with an absent atom against its plain version on A1's
    data steps (dense and gather, ts-delta and raw-ts) and on timer
    launches over the whole 2^20-key slab, wakes included; then random
    traffic (volumes 1-4, no padding rows: the plain gather step ticks a
    clamped copy of the last key for a padding row, the kernel skips it).
    Returns (max err, steps compared, timing inputs)."""
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(A1_QL)
    planned = rt.query_runtimes["q"].planned
    P = planned.slots
    plain = planned.init_state(A1_KEYS)[0]
    kern = clone_state(plain)
    max_err, n = 0.0, 0
    timing = {}

    def data(sid, cols, ts, wire, dense, label):
        nonlocal plain, kern, max_err, n
        args = absent_step_args(torch, np, dev, planned, cols, ts, wire,
                                dense)
        steps = (planned.dense_steps_w if wire else planned.dense_steps) \
            if dense else (planned.steps_w if wire else planned.steps)
        before = clone_state(kern)
        a = steps[sid].plain(plain, (), *args)
        b = steps[sid].kernel(kern, (), *args)
        torch.cuda.synchronize()
        EP = planned.slots + 1
        max_err = max(max_err, absent_compare(
            torch, a, b, label, min(planned.compact_rows, EP) < EP))
        plain, kern, n = a[0], b[0], n + 1
        return before, args, steps[sid]

    def timer(now, label):
        nonlocal plain, kern, max_err, n
        before = clone_state(kern)
        a = planned.timer_step.plain(plain, (), now)
        b = planned.timer_step.kernel(kern, (), now)
        torch.cuda.synchronize()
        max_err = max(max_err, absent_compare(torch, a, b, label,
                                              min(8, P + 1) < P + 1))
        plain, kern, n = a[0], b[0], n + 1
        return before, int(b[2][0])

    for i in range(5):
        (c1, t1), (c2, t2) = a1_sends(np, i)
        wire = i != 3
        kind = "ts-delta" if wire else "raw-ts"
        got = data("S1", c1, t1, wire, True, f"A1 S1 step {i} (dense, {kind})")
        if i == 0:
            timing["data"] = got
        data("S2", c2, t2, wire, False, f"A1 S2 step {i} (gather, {kind})")
    before, fired = timer(1000 + 1000, "A1 timer at 2000 (block 0 due)")
    if fired != A1_BLOCK // 2:
        fail(f"A1 timer fired {fired} rows, expected {A1_BLOCK // 2}")
    timing["timer"] = (before, 2000)
    timer(2000, "A1 timer at 2000 again (nothing due)")
    rng = np.random.default_rng(43)
    for i in range(4):
        m = A1_KEYS // 32
        keys = np.sort(rng.choice(A1_KEYS, m, replace=False)).astype(np.int64)
        cols = [keys, rng.integers(1, 5, m).astype(np.int32)]
        ts = 2100 + 300 * i + np.sort(rng.integers(0, 250, m)).astype(
            np.int64)
        data(("S1", "S2")[i % 2], cols, ts, i != 2, False,
             f"random step {i} (gather, {m} keys)")
    timer(3400, "timer at 3400")
    print(f"compare: pattern_step (absent atoms, timer mode) == plain over "
          f"{n} steps, max_abs_err {max_err}")
    return max_err, n, (planned, timing)


def time_absent_kernel(torch, np, dev, tinfo):
    """pattern_step per launch at A1's data step (131,072 keys, one event
    each, dense) and its timer step (the whole 2^20-key slab, 65,536
    absent deadlines due), CUDA-graph replays between CUDA events; and
    the general mode on A1's plan (held equal, timed the same way)."""
    from siddhi_tpu_torch.kernels import pattern_step as ps
    planned, timing = tinfo
    res = {}
    before, args, step = timing["data"]
    state = clone_state(before)
    gkp, gtkp = general_plans(dev, A1_QL, "q", "S1")

    def restore():
        restore_into(state, before)
    kp = step.kernel_plan
    cols, base, delta, sel, key_lo, now = args

    def dlaunch(k):
        return ps.launch(k, state, cols, None, (base, delta), sel, key_lo,
                         now, True)
    same_launch(torch, restore, state, dlaunch, kp, gkp, "A1 data step")
    res["data"] = {
        "ms": graph_ms(torch, lambda: dlaunch(kp), 20, restore),
        "gen_ms": graph_ms(torch, lambda: dlaunch(gkp), 20, restore),
        "plain_ms": event_timer(torch, lambda: step.plain(state, (), *args),
                                3, restore)}
    # per key: its selection and event (sel 4, key 8, v 4, ts delta 4),
    # the P active and the seed_on / done words read, the spawned slot's
    # active, pos, count, lmask (4 each), start, entry, capture ts and key
    # (8 each) and v (4) written, and the valid flags of its P + 1 rows
    P = planned.slots
    Kb = sel.shape[0]
    res["data"].update(bound(Kb * (20 + 4 * (P + 2) + 52 + (P + 1))))
    tbefore, now = timing["timer"]
    state = clone_state(tbefore)

    def trestore():
        restore_into(state, tbefore)
    tkp = planned.timer_step.kernel_plan

    def tlaunch(k):
        return ps.launch(k, state, None, None, None, None, None, now, True,
                         timer=True)
    same_launch(torch, trestore, state, tlaunch, tkp, gtkp, "A1 timer step")
    kout = tlaunch(tkp)[1]
    fired = int(kout[0][0])
    K = tbefore[0].shape[1]
    act = tbefore[0][:P].to(torch.bool)
    n_act = int(act.sum())
    res["timer"] = {
        "ms": graph_ms(torch, lambda: tlaunch(tkp), 20, trestore),
        "gen_ms": graph_ms(torch, lambda: tlaunch(gtkp), 20, trestore),
        "plain_ms": event_timer(torch, lambda: planned.timer_step.plain(
            state, (), now), 3, trestore)}
    # phase 2 reads every slot's active word and, of each active slot, its
    # pos and entry words; it writes the active word of each slot that
    # fires; the launch writes the valid flag of every output row
    # ((P + 1) a key) and the ts, kind and emitted column of each fired row
    res["timer"].update(bound(K * P * 4 + n_act * (4 + 8) + fired * 4 +
                              K * (P + 1) + fired * (8 + 4 + 8)))
    res["timer"]["fired"], res["timer"]["active"] = fired, n_act
    for k, t in res.items():
        print(f"timing pattern_step (A1 {k} step): kernel {t['ms']:.4f} "
              f"ms/launch, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
              f"bytes); the general mode on the same plan "
              f"{t['gen_ms']:.4f} ms/launch")
    print(f"timing pattern_step (A1 timer step): {K} keys, {n_act} active "
          f"slots, {fired} fired")
    return res


def run_s1(torch, np, dev, mods, B, rows, warm, timed, label, profile):
    """S1 (or S1-wide) through SiddhiManager: every send's match count
    against the closed form, the kernel launched and the plain version
    never called."""
    from siddhi_tpu_torch import SiddhiManager
    rng = np.random.default_rng(4)
    sends = [s1_send(np, rng, i, B) for i in range(warm + timed)]
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(S1_QL.format(rows=rows))
    rt.start()
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "q", "S", sends, warm, mods, timed=timed)
    counts = [c[0] for c in counts]
    want = [s1_matches(np, c) for c, _ in sends]
    if counts != want:
        bad = [i for i, (a, b) in enumerate(zip(counts, want)) if a != b]
        fail(f"{label}: match counts of sends {bad[:4]} are "
             f"{[counts[i] for i in bad[:4]]}, the closed form "
             f"{[want[i] for i in bad[:4]]}")
    check_launched(label, launches, plain, ["block_nfa"])
    h2d = B * (8 + 4 + 4 + 4 + 4)
    lat_line(np, label, lat, wall, timed * B, h2d)
    print(f"{label}: matches {sum(counts[warm:])} over the timed sends, "
          f"equal to the closed form on every send")
    prof = None
    if profile:
        h = rt.get_input_handler("S")
        extra = [s1_send(np, rng, warm + timed + i, B) for i in range(4)]
        prof = device_profile(torch, rt, len(extra), lambda b: h.send_columns(
            extra[b][0], timestamps=extra[b][1]))
        profile_line(label, len(extra), prof)
    mgr.shutdown()
    return launches["block_nfa"]


def profile_line(label, n, prof):
    if prof["device_ms"] is None:
        print(f"{label} profile ({n} sends): wall {prof['wall_ms']:.3f} ms, "
              f"device time not measured")
        return
    print(f"{label} profile ({n} sends): wall {prof['wall_ms']:.3f} ms, "
          f"device busy {prof['device_ms']:.3f} ms (idle share "
          f"{prof['idle_share']:.4f}); top device ops: "
          + "; ".join(f"{k} {t:.3f} ms over {c} calls"
                      for k, t, c in prof["top"]))


def run_s2(torch, np, dev, mods):
    """The pattern sample through SiddhiManager (16 sends of 16,384 events,
    64 symbols, ts +1 ms an event), then the same sends again on a fresh
    runtime with every block step held to its plain version (state words,
    dropped, header, rows)."""
    from siddhi_tpu_torch import SiddhiManager
    with open("samples/apps/pattern_matching.siddhi") as fh:
        ql = fh.read()
    mgr = SiddhiManager(device=dev)
    ids = np.array([mgr.interner.intern(f"SYM{i}") for i in range(S2_SYMS)],
                   np.int32)
    rng = np.random.default_rng(44)
    sends = [s2_send(np, rng, i, S2_B, ids) for i in range(16)]
    rt = mgr.create_siddhi_app_runtime(ql)
    rt.start()
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "riseQuery", "StockStream", sends, 0, mods,
        timed=16)
    counts = [c[0] for c in counts]
    check_launched("S2", launches, plain, ["block_nfa"])
    lat_line(np, "S2", lat, wall, 16 * S2_B, S2_B * (4 + 4 + 4 + 4))
    mgr.shutdown()
    # the replay, each step against its plain version
    mgr = SiddhiManager(device=dev)
    for i in range(S2_SYMS):
        mgr.interner.intern(f"SYM{i}")
    rt = mgr.create_siddhi_app_runtime(ql)
    qr = rt.query_runtimes["riseQuery"]
    p = qr.planned
    for table in (p.steps, p.steps_w):
        inner = table["StockStream"]

        class Shadow:
            def __init__(self, inner):
                self.inner = inner
                self.kernel_plan = inner.kernel_plan

            def __call__(self, packed, sel_state, raw_cols, *args):
                a = self.inner.body(clone_state(packed), sel_state,
                                    raw_cols, *args)
                b = self.inner(packed, sel_state, raw_cols, *args)
                torch.cuda.synchronize()
                compare_steps(torch, a, b, "S2 replay step", False)
                replayed[0] += 1
                return b
        table["StockStream"] = Shadow(inner)
    replayed = [0]
    got = []
    rt.add_batch_callback("riseQuery", lambda ts, b: got.append(
        b["n_current"]))
    h = rt.get_input_handler("StockStream")
    for cols, ts in sends:
        h.send_columns(cols, timestamps=ts)
    rt.flush()
    mgr.shutdown()
    if got != counts or replayed[0] != len(sends):
        fail(f"S2 replay: {replayed[0]} steps compared, counts {got[:4]} "
             f"against the timed run's {counts[:4]}")
    print(f"S2: K8 == plain on all {replayed[0]} replayed sends (rows, "
          f"header, state words, dropped); {sum(counts)} matches")
    return launches["block_nfa"]


def run_a1(torch, np, dev, mods):
    """A1 through SiddhiManager: 8 filling + 16 timed sends (each an S1
    step over 131,072 keys and an S2 step over their 65,536 even keys);
    the timer steps fire exactly the odd keys of each block, once each, at
    e1.ts + 1000, and launch in timer mode over the whole slab."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(A1_QL)
    fired = {}                  # block send -> number of rows fired
    checked = [0]

    def on_batch(ts, b):
        n = b["n_current"]
        if not n:
            return
        if checked[0] < 3:
            v = b["valid"]
            k = b["cols"]["k"][v]
            t = b["ts"][v]
            i = (int(t[0]) - 2000) // 250
            blk = i % (A1_KEYS // A1_BLOCK)
            want = np.arange(blk * A1_BLOCK + 1, (blk + 1) * A1_BLOCK, 2)
            if not (np.array_equal(np.sort(k), want) and
                    np.all(t == 1000 + 250 * i + 1000)):
                fail(f"A1: the rows fired at {ts} are not the odd keys of "
                     f"block {blk} at {1000 + 250 * i + 1000}")
            checked[0] += 1
        i = (ts - 2000) // 250
        fired[i] = fired.get(i, 0) + n
    rt.add_batch_callback("q", on_batch)
    rt.start()
    h1, h2 = rt.get_input_handler("S1"), rt.get_input_handler("S2")
    warm, timed = 8, 16
    sends = [a1_sends(np, i) for i in range(warm + timed)]
    for m in mods.values():
        m.reset_counts()
    lat = []
    for i, ((c1, t1), (c2, t2)) in enumerate(sends):
        if i == warm:
            rt.flush()
            t_start = time.perf_counter()
        tb = time.perf_counter()
        h1.send_columns(c1, timestamps=t1)
        h2.send_columns(c2, timestamps=t2)
        if i >= warm:
            lat.append(time.perf_counter() - tb)
    rt.flush()
    wall = time.perf_counter() - t_start
    launches = {k: m.launches for k, m in mods.items()}
    plain = {k: m.plain_calls for k, m in mods.items()}
    from siddhi_tpu_torch.kernels import pattern_step as ps
    timer_launches = ps.timer_launches
    # deadlines of sends 0 .. 19 have fallen due by send 23 (4 sends later)
    want = {i: A1_BLOCK // 2 for i in range(warm + timed - 4)}
    if fired != want:
        fail(f"A1: fired rows by e1 send {sorted(fired.items())[:6]}, "
             f"expected {A1_BLOCK // 2} for each of sends 0-"
             f"{warm + timed - 5}")
    if timer_launches <= 0:
        fail("A1: the timer step never launched the kernel in timer mode")
    check_launched("A1", launches, plain, ["pattern_step"])
    print(f"A1: {sum(fired.values())} rows fired, the odd keys of every "
          f"block once each (3 batches checked row by row); timer-mode "
          f"launches {timer_launches}")
    lat_line(np, "A1", lat, wall, timed * (A1_BLOCK + A1_BLOCK // 2),
             (A1_BLOCK + A1_BLOCK // 2) * (8 + 4 + 4 + 4 + 4))
    # a profiled sweep of 8 more sends (4 of them fire a block)
    more = [a1_sends(np, warm + timed + i) for i in range(8)]

    def send(b):
        (c1, t1), (c2, t2) = more[b]
        h1.send_columns(c1, timestamps=t1)
        h2.send_columns(c2, timestamps=t2)
    profile_line("A1", len(more), device_profile(torch, rt, len(more), send))
    mgr.shutdown()
    return launches["pattern_step"], timer_launches


def run_a2(torch, np, dev):
    """A2: the absent shapes of the JAX package's absent corpus and its
    idle-advance test, a few events each, on the card: the events must be
    those the JAX package gives (the CPU tests hold these expectations to
    it)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps
    ps.reset_counts()
    for name, body, sends, want in A2_CASES:
        got = a2_run(SiddhiManager(device=dev), body, sends)
        if got != want:
            fail(f"A2 {name}: events {got}, expected {want}")
    got = a2_idle(SiddhiManager(device=dev))
    if got != A2_IDLE_WANT:
        fail(f"A2 idle advance: events {got}, expected {A2_IDLE_WANT}")
    if ps.launches <= 0 or ps.plain_calls:
        fail(f"A2: kernel launches {ps.launches}, plain calls "
             f"{ps.plain_calls}")
    print(f"A2: {len(A2_CASES)} absent-corpus shapes and the idle advance "
          f"give the JAX package's events; launches {ps.launches}, timer "
          f"launches {ps.timer_launches}, plain calls {ps.plain_calls}")


def a2_run(mgr, body, sends):
    rt = mgr.create_siddhi_app_runtime(A2_BASE + body)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.extend(
        tuple(e.data) for e in (i or [])))
    rt.start()
    for stream, data, ts in sends:
        rt.get_input_handler(stream).send(list(data), timestamp=ts)
    rt.flush()
    mgr.shutdown()
    return got


def a2_idle(mgr, timeout=10.0):
    """The idle-advance case: one S1 event, then silence; the idle thread
    walks the playback clock past the deadline.  Polls with a deadline."""
    rt = mgr.create_siddhi_app_runtime(A2_IDLE_QL)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.extend(
        tuple(e.data) for e in (i or [])))
    rt.start()
    try:
        rt.get_input_handler("S1").send(["WSO2", 55.6], timestamp=1000)
        end = time.time() + timeout
        while not got and time.time() < end:
            time.sleep(0.02)
    finally:
        mgr.shutdown()
    return [tuple(x) for x in got]


def pattern_phases(torch, np, dev):
    """Phases 14-17: K8 and pattern_step's absent and timer modes against
    their plain versions, their times beside their bounds, and S1,
    S1-wide, S2, A1 and A2 through SiddhiManager.  Returns the K8 and
    timer-mode records."""
    from siddhi_tpu_torch.kernels import block_nfa as bn
    from siddhi_tpu_torch.kernels import pattern_step as ps
    err_b, nb, btiming = compare_block_kernel(torch, np, dev)
    tb = {k: time_block_kernel(torch, np, dev, btiming, k)
          for k in ("S1", "S1-wide")}
    del btiming
    err_a, na, atiming = compare_absent_kernel(torch, np, dev)
    ta = time_absent_kernel(torch, np, dev, atiming)
    del atiming
    torch.cuda.empty_cache()
    bmods = {"block_nfa": bn}
    launches = run_s1(torch, np, dev, bmods, S1_B, 4096, 1, 32, "S1", False)
    launches += run_s1(torch, np, dev, bmods, S1W_B, 65536, 1, 16,
                       "S1-wide", True)
    launches += run_s2(torch, np, dev, bmods)
    a_launch, t_launch = run_a1(torch, np, dev, {"pattern_step": ps})
    run_a2(torch, np, dev)
    print(f"kernel block_nfa: S1's shape {tb['S1']['ms']:.4f} ms (bound "
          f"{tb['S1']['bound_ms']:.5f}), S1-wide's {tb['S1-wide']['ms']:.4f}"
          f" ms (bound {tb['S1-wide']['bound_ms']:.5f}), launches on the "
          f"main paths {launches}; library_ms null: no torch call runs an "
          f"NFA over a stream (the earlier design, a thread scanning its "
          f"row's events one by one, took S1 0.158-0.172 ms and S1-wide "
          f"9.13-9.35 ms on an H100 80GB HBM3 at 700 W; "
          f"scripts/time_k19_k8.py times both designs in one call)")
    print(f"kernel pattern_step timer mode: {ta['timer']['ms']:.4f} ms over "
          f"the 2^20-key slab (bound {ta['timer']['bound_ms']:.5f}); A1's "
          f"data step {ta['data']['ms']:.4f} ms (bound "
          f"{ta['data']['bound_ms']:.5f}); launches on A1's path {a_launch} "
          f"data, {t_launch} timer; library_ms null: no torch call runs a "
          f"pattern's deadlines")
    t = tb["S1-wide"]
    return [{"name": "block_nfa", "route": "cuda",
             "source": "siddhi_tpu_torch/csrc/block_nfa.cu",
             "replaces": "siddhi_tpu/core/pattern_block.py:68",
             "launches": launches, "max_abs_err": err_b, "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": None},
            {"name": "pattern_step_timer", "route": "cuda",
             "source": "siddhi_tpu_torch/csrc/pattern_step.cu",
             "replaces": "siddhi_tpu/core/pattern_planner.py:396",
             "launches": t_launch, "max_abs_err": err_a,
             "ms": ta["timer"]["ms"], "plain_ms": ta["timer"]["plain_ms"],
             "bound_ms": ta["timer"]["bound_ms"],
             "bound_by": ta["timer"]["bound_by"], "library_ms": None}]


# ---------------------------------------------------------------------------
# in-memory tables: K9 table_write, K10 table_match, K7's table modes
# ---------------------------------------------------------------------------

T1_ROWS = 1 << 20         # StockTable's capacity and its ids
T1_B = 1 << 17            # rows a send on each stream
T1_FILL = 8               # sends that fill the table
T1_TIMED = 16
T1_MISS = 1 << 16         # CheckStock ids reach 2^20 + 2^16 (about 6% miss)
T2_SYMS = 4096
T2_SENDS = 16
IDX18_ROWS = 1 << 16      # the @Index twin's rows, 4,096 groups


def subcounts(mods):
    """The main path's launches of each table kernel record."""
    tw, tm, jp = mods["table_write"], mods["table_match"], \
        mods["join_probe"]
    return {"table_write": tw.launches, "table_delete": tw.delete_launches,
            "table_match": tm.launches - tm.dense_launches,
            "table_match_dense": tm.dense_launches,
            "join_probe_table": jp.index_launches,
            "join_probe_table_grid": jp.grid_table_launches,
            "join_probe index": jp.index_launches,
            "join_probe grid": jp.grid_table_launches}


def table_modules():
    from siddhi_tpu_torch.kernels import filter_compact, join_probe, \
        table_match, table_write
    return {"filter_compact": filter_compact, "join_probe": join_probe,
            "table_match": table_match, "table_write": table_write}


class Recording:
    """Within the block, the table paths' K7 and K10 calls are recorded
    (outputs, and the arguments of the last call of each kind for
    timing).  `plain=True` also routes K1, K7, K9 and K10 to their plain
    versions on the card, so a twin runtime gives the reference of every
    stage."""

    def __init__(self, rec, plain=False, args=None):
        self.rec, self.plain, self.args = rec, plain, args
        self.m = table_modules()

    def __enter__(self):
        m = self.m
        fc, jp, tm, tw = (m[k] for k in ("filter_compact", "join_probe",
                                         "table_match", "table_write"))
        self.saved = (fc.filter_compact, jp.join_probe, tm.table_match,
                      tw.write, tw.masked_delete)
        rec, args = self.rec, self.args
        k_jp = jp.plain if self.plain else jp.join_probe
        k_tm = tm.plain if self.plain else tm.table_match

        def rec_jp(spec, trig, o_cols, o_meta, lanes, nbl, cap, hdr,
                   o_valid=None, cand=None):
            out = k_jp(spec, trig, o_cols, o_meta, lanes, nbl, cap, hdr,
                       o_valid, cand)
            rec.append(("K7", out + (hdr,)))
            if args is not None:
                args["K7 index" if cand is not None else "K7 grid"] = (
                    spec, trig, o_cols, o_meta, lanes, nbl, cap, hdr,
                    o_valid, cand)
            return out

        def rec_tm(spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid,
                   cand=None):
            out = k_tm(spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid,
                       cand)
            rec.append(("K10", out))
            if args is not None:
                args["K10 cand" if cand is not None else "K10 dense"] = (
                    spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid,
                    cand)
            return out
        jp.join_probe, tm.table_match = rec_jp, rec_tm
        if self.plain:
            fc.filter_compact = fc.plain
            tw.write = lambda cols, ts, valid, win, *a: \
                tw.plain_write(cols, ts, valid, *a)
            tw.masked_delete = tw.plain_delete
        elif args is not None:
            orig = tw.write

            def rec_tw(*a):
                orig(*a)
                args["K9 write"] = a
            tw.write = rec_tw
        return self

    def __exit__(self, *exc):
        m = self.m
        (m["filter_compact"].filter_compact, m["join_probe"].join_probe,
         m["table_match"].table_match, m["table_write"].write,
         m["table_write"].masked_delete) = self.saved


def table_state_err(torch, np, ta, tb, what):
    """Two tables hold the same rows and host bookkeeping (0.0) or fail."""
    from siddhi_tpu_torch import convert
    a, b = convert.table_to_numpy(ta), convert.table_to_numpy(tb)
    for x, y in zip(a["cols"] + [a["ts"], a["valid"]],
                    b["cols"] + [b["ts"], b["valid"]]):
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        if not np.array_equal(x, y):
            fail(f"{what}: table columns differ (kernel vs plain)")
    for k in ("append_ptr", "free_rows"):
        if a[k] != b[k]:
            fail(f"{what}: {k} differs")
    if ta._win is not None and bool((ta._win != -1).any()):
        fail(f"{what}: K9's claim words were not reset")
    return 0.0


def twin_send(torch, np, rts, stream, cols, ts, what, args=None,
              stats=None):
    """One send into the kernel runtime and its plain twin, every K7 and
    K10 output and both tables compared."""
    ra, rb = [], []
    with Recording(ra, args=args):
        rts[0].get_input_handler(stream).send_columns(cols, timestamps=ts)
    with Recording(rb, plain=True):
        rts[1].get_input_handler(stream).send_columns(cols, timestamps=ts)
    torch.cuda.synchronize()
    if [t for t, _ in ra] != [t for t, _ in rb]:
        fail(f"{what}: kernel path {[t for t, _ in ra]}, plain path "
             f"{[t for t, _ in rb]}")
    for (tag, xa), (_, xb) in zip(ra, rb):
        for j, (x, y) in enumerate(zip(xa, xb)):
            if not torch.equal(x, y):
                fail(f"{what}: {tag} output {j} differs from its plain "
                     f"version")
        if stats is not None:
            stats[tag] = stats.get(tag, 0) + 1
    for tid in rts[0].tables:
        table_state_err(torch, np, rts[0].tables[tid], rts[1].tables[tid],
                        f"{what} table {tid}")
    return 0.0


def twin(dev, ql):
    from siddhi_tpu_torch import SiddhiManager
    rts = [SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
           for _ in range(2)]
    for rt in rts:
        rt.start()
    return rts


def t1_sends(np, rng, n, fill=False, perm=None, first=0):
    """T1's traffic: a fill send upserts its block of the permutation, a
    steady send upserts ids uniform over 2^20 then checks ids uniform over
    [0, 2^20 + 2^16)."""
    out = []
    for i in range(first, first + n):
        ts = np.full(T1_B, 1000 + 10 * i, np.int64)
        ids = perm[i * T1_B:(i + 1) * T1_B] if fill else \
            rng.integers(0, T1_ROWS, T1_B).astype(np.int64)
        out.append(("StockUpdate", [ids.astype(np.int64),
                                    rng.random(T1_B, np.float32),
                                    rng.integers(0, 1 << 40, T1_B)
                                    .astype(np.int64)], ts))
        if not fill:
            out.append(("CheckStock",
                        [rng.integers(0, T1_ROWS + T1_MISS, T1_B)
                         .astype(np.int64),
                         rng.integers(1, 100, T1_B).astype(np.int32)],
                        ts + 1))
    return out


def compare_table_kernels(torch, np, dev):
    """Phase 18: K9, K10 and K7's table modes against their plain versions
    on the card, stage by stage, through twin runtimes (one launching the
    kernels, one calling the plain versions) over the same sends.  Returns
    the largest difference (0.0), the timing inputs and counts."""
    args, stats = {}, {}
    timing = {}
    rng = np.random.default_rng(41)
    # T1's shape: the fill with a send of duplicate new and existing keys,
    # steady upserts (K10 over the allocator's candidates) and joins (K7's
    # fast path)
    rts = twin(dev, T1_QL)
    perm = rng.permutation(T1_ROWS).astype(np.int64)
    fill = t1_sends(np, rng, T1_FILL, fill=True, perm=perm)
    for i, (s, c, ts) in enumerate(fill):
        twin_send(torch, np, rts, s, c, ts, f"T1 fill {i}", args, stats)
        if i == 0:
            timing["K9 write (T1 fill)"] = args["K9 write"]
            dup = np.concatenate([perm[:T1_B // 2],
                                  perm[T1_B:T1_B + T1_B // 2]])
            ids = dup[rng.integers(0, dup.shape[0], T1_B)]
            twin_send(torch, np, rts, "StockUpdate",
                      [ids, rng.random(T1_B, np.float32),
                       rng.integers(0, 1 << 40, T1_B).astype(np.int64)],
                      ts, "T1 duplicate new and existing keys", args, stats)
    for j, (s, c, ts) in enumerate(t1_sends(np, rng, 2, first=T1_FILL)):
        twin_send(torch, np, rts, s, c, ts, f"T1 steady {j}", args, stats)
    timing["K10 cand (T1)"] = args.pop("K10 cand")
    timing["K7 index (T1)"] = args.pop("K7 index")
    t1_table = rts[0].tables["StockTable"]
    del rts
    # T2's shape: the table_crud sample's first send (a permutation: K10
    # dense without a hit, then K9 appends 4,096 rows) and a second
    # (uniform: K10 dense, 4,096 x 4,096, with hits); the symbols travel
    # as the ids 0..4,095
    with open("samples/apps/table_crud.siddhi") as fh:
        rts = twin(dev, fh.read())
    for i in range(2):
        k = rng.permutation(T2_SYMS) if i == 0 else \
            rng.integers(0, T2_SYMS, T2_SYMS)
        twin_send(torch, np, rts, "UpdateStream",
                  [k.astype(np.int32), rng.random(T2_SYMS, np.float32)],
                  np.full(T2_SYMS, 1500 + i, np.int64), f"T2 send {i}",
                  args, stats)
        if i == 0:
            timing["K9 write (T2)"] = args.pop("K9 write")
    timing["K10 dense (T2)"] = args.pop("K10 dense")
    del rts
    # appends that reuse freed rows, a masked delete and K7's grid over an
    # unindexed table (inner and left outer)
    rts = twin(dev, CRUD18_QL)
    ids = rng.permutation(T2_SYMS).astype(np.int32)
    n0 = 3 * T2_SYMS // 4

    def send(stream, cols, i):
        twin_send(torch, np, rts, stream, cols,
                  np.full(len(cols[0]), 2000 + i, np.int64),
                  f"CRUD send {i} ({stream})", args, stats)
    send("Ins", [ids[:n0], rng.random(n0, np.float32)], 0)
    send("Del", [rng.choice(ids[:n0], T2_SYMS // 6, replace=False)], 1)
    send("Ins", [ids[n0:], rng.random(T2_SYMS - n0, np.float32)], 2)
    send("Probe", [rng.integers(0, T2_SYMS, T2_SYMS).astype(np.int32)], 3)
    send("Ups", [rng.integers(0, T2_SYMS, T2_SYMS).astype(np.int32),
                 rng.random(T2_SYMS, np.float32)], 4)
    send("Probe", [rng.integers(0, T2_SYMS, T2_SYMS).astype(np.int32)], 5)
    timing["K7 grid"] = args.pop("K7 grid")
    del rts
    # K10 dense over a 2^20-row table with 1,024 batch rows
    rts = twin(dev, BIG18_QL)
    twin_send(torch, np, rts, "In",
              [np.arange(T1_ROWS, dtype=np.int64),
               rng.integers(0, 1000, T1_ROWS).astype(np.int32)],
              np.full(T1_ROWS, 3000, np.int64), "2^20-row fill", args, stats)
    twin_send(torch, np, rts, "Up",
              [rng.integers(0, T1_ROWS, 1024).astype(np.int64),
               rng.integers(0, 1000, 1024).astype(np.int32)],
              np.full(1024, 3001, np.int64), "2^20 x 1,024 dense update",
              args, stats)
    timing["K10 dense (2^20 x 1,024)"] = args.pop("K10 dense")
    del rts
    # K10 over an @Index's candidates (K > 1)
    rts = twin(dev, IDX18_QL)
    n = IDX18_ROWS
    twin_send(torch, np, rts, "In",
              [np.arange(n, dtype=np.int64),
               rng.integers(0, 4096, n).astype(np.int32),
               rng.integers(0, 100, n).astype(np.int32)],
              np.full(n, 4000, np.int64), "indexed fill", args, stats)
    twin_send(torch, np, rts, "Del",
              [rng.integers(0, 4096, 1024).astype(np.int32),
               rng.integers(0, 100, 1024).astype(np.int32)],
              np.full(1024, 4001, np.int64), "indexed delete", args, stats)
    k_idx = int(args["K10 cand"][6].shape[1])
    del rts
    torch.cuda.empty_cache()
    print(f"compare (tables): K9, K10 and K7's table modes == their plain "
          f"versions on every stage: {stats.get('K10', 0)} K10 and "
          f"{stats.get('K7', 0)} K7 launches compared, both tables after "
          f"every send (T1's 2^20-row shape with duplicate new and existing "
          f"keys, freed-row reuse, a masked delete, K10 dense at 4,096 x "
          f"4,096 and 2^20 x 1,024, K10 over @Index candidates with K = "
          f"{k_idx}, K7's grid inner and left outer and its fast path), "
          f"max_abs_err 0.0")
    return 0.0, timing, t1_table


def code_bytes(code, ev_cols, other_cols):
    """The bytes of one row of the columns a bytecode loads: (its LOAD_EV
    columns, its LOAD_OTHER columns)."""
    from siddhi_tpu_torch.kernels.filter_bytecode import LOAD_EV, \
        LOAD_OTHER, _OP_LEN
    loads, pc = {LOAD_EV: set(), LOAD_OTHER: set()}, 0
    while pc < len(code):
        if code[pc] in loads:
            loads[code[pc]].add(code[pc + 1])
        pc += _OP_LEN[code[pc]]
    return (sum(ev_cols[c].element_size() for c in loads[LOAD_EV]),
            sum(other_cols[c].element_size() for c in loads[LOAD_OTHER]))


def k9_bound(np, args):
    cols, ts, valid, win, new_cols, new_ts, slots, row_valid = args
    rv = row_valid.cpu().numpy()
    s = slots.cpu().numpy()
    C = ts.shape[0]
    live = rv & (s >= 0) & (s < C)
    uniq = np.unique(s[live]).shape[0]
    nb = sum(c.element_size() for c in new_cols)
    tb = sum(c.element_size() for c in cols)
    return bound(rv.shape[0] + int(live.sum()) * (nb + 8 + 4) +
                 uniq * (tb + 8 + 1))


def k10_bound(torch, np, args):
    spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid, cand = args
    eb, ob = code_bytes(spec.code, ev_cols, tab_cols)
    B, C = ev_valid.shape[0], tab_valid.shape[0]
    out = 5 * C + B
    if cand is None:
        return bound(B * (1 + eb) + C * (1 + ob) + out, B * C)
    c = cand.to(torch.int64)
    ok = (c >= 0) & ev_valid[:, None]
    n = int(ok.sum())
    return bound(B + cand.numel() * 4 + int(ok.any(dim=1).sum()) * eb +
                 n * (1 + ob) + out, n)


def k7_bound(torch, args, hdr_after):
    spec, trig, o_cols, o_meta, lanes, nbl, cap, hdr, o_valid, cand = args
    eb, ob = code_bytes(spec.on_code, trig.cols, o_cols)
    data = trig.valid & ((trig.kind == 0) | (trig.kind == 1))
    R = int(data.sum())
    nv = int(hdr_after[0])
    out = nv * 10 + (cap - nv) + 24
    if cand is not None:
        bix = torch.clamp(trig.cols[-1][data].to(torch.int64), 0,
                          cand.shape[0] - 1)
        cs = cand[bix].to(torch.int64)
        n = int((cs >= 0).sum())
        return bound(R * (4 + 1 + 4 + eb) + cand.numel() * 4 +
                     n * (1 + ob) + out, n)
    C_live = int(o_valid.sum())
    return bound(R * (4 + 1 + eb) + o_valid.shape[0] +
                 C_live * ob + out, R * C_live)


def time_table_kernels(torch, np, dev, timing, t1_table):
    """Phase 19: K9, K10 and K7's table modes per launch (CUDA-graph
    replays between CUDA events) at T1's and T2's shapes, beside their
    plain versions, their bounds and, where one exists, one torch call."""
    m = table_modules()
    tw, tm, jp = m["table_write"], m["table_match"], m["join_probe"]
    res = {}
    a = timing["K9 write (T1 fill)"]
    cols, ts, valid, win, new_cols, new_ts, slots, row_valid = a
    res["table_write"] = {
        "ms": graph_ms(torch, lambda: tw.launch_write(*a), 20),
        "plain_ms": event_timer(torch, lambda: tw.plain_write(
            cols, ts, valid, new_cols, new_ts, slots, row_valid), 3),
        **k9_bound(np, a), "shape": "T1's fill: 131,072 new rows into "
        "2^20"}
    a2 = timing["K9 write (T2)"]
    res["table_write T2"] = {
        "ms": graph_ms(torch, lambda: tw.launch_write(*a2), 20),
        "plain_ms": event_timer(torch, lambda: tw.plain_write(
            *a2[:3], *a2[4:]), 3),
        **k9_bound(np, a2), "shape": "T2's first send: 4,096 rows into "
        "4,096"}
    vsave = t1_table.valid.clone()
    kill = torch.from_numpy(np.random.default_rng(9).random(T1_ROWS)
                            < 0.1).to(dev)
    v = vsave.clone()

    def restore():
        v.copy_(vsave)
    res["table_delete"] = {
        "ms": graph_ms(torch, lambda: tw.launch_delete(v, kill), 20,
                       restore),
        "plain_ms": event_timer(torch, lambda: tw.plain_delete(v, kill), 20,
                                restore),
        "library_ms": event_timer(torch, lambda: torch.logical_and(
            v, kill.logical_not()), 20, restore),
        **bound(3 * T1_ROWS), "shape": "T1's table: 2^20 rows"}
    for key, name, shape in (
            ("K10 cand (T1)", "table_match", "T1: 131,072 rows, K = 1"),
            ("K10 dense (T2)", "table_match_dense", "T2: 4,096 x 4,096"),
            ("K10 dense (2^20 x 1,024)", "table_match_dense 2^20",
             "2^20 table rows x 1,024")):
        spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid, cand = \
            timing[key]
        reps = 3 if "2^20 x" in key else 20
        res[name] = {
            "ms": graph_ms(torch, lambda: tm.launch(
                spec, ev_cols, ev_valid, tab_cols, tab_valid, cand), reps),
            "plain_ms": event_timer(torch, lambda: tm.plain(
                spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid, cand),
                1 if "2^20 x" in key else 3),
            **k10_bound(torch, np, timing[key]), "shape": shape}
    for key, name, shape in (
            ("K7 index (T1)", "join_probe_table", "T1: 131,072 trigger "
             "rows, K = 1, 2^20 table rows"),
            ("K7 grid", "join_probe_table_grid",
             "4,096 trigger rows x an 8,192-row table with T2's 4,096 "
             "symbols")):
        a = timing[key]
        hd = torch.zeros(3, dtype=torch.int64, device=dev)
        k = a[:7] + (hd,) + a[8:]
        jp.launch(*k)
        torch.cuda.synchronize()
        if hd.tolist() != a[7].tolist():
            fail(f"join_probe ({key}): the timed inputs give header "
                 f"{hd.tolist()}, the compared step {a[7].tolist()}")
        res[name] = {
            "ms": graph_ms(torch, lambda: jp.launch(*k), 20),
            "plain_ms": event_timer(torch, lambda: jp.plain(*k), 3),
            **k7_bound(torch, a, hd.tolist()), "shape": shape}
    for name, t in res.items():
        lib = f", library {t['library_ms']:.4f} ms" \
            if t.get("library_ms") is not None else ""
        print(f"timing {name} ({t['shape']}): kernel {t['ms']:.4f} "
              f"ms/launch, plain {t['plain_ms']:.4f} ms{lib}, bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
              f"bytes, {t['ops']} ops)")
    return res


def run_t1(torch, np, dev, mods):
    """T1 at full size: 8 sends fill the 2^20-row table through the upsert,
    16 timed sends of 131,072 upserts and 131,072 enrichment probes; every
    join header, the last send's joined rows and the final table held to a
    numpy model (the last writer in batch order wins); then a profiled
    sweep with the host time of the indexed match and the allocator."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(T1_QL)
    got = []
    rt.add_batch_callback("enrich", lambda ts, b: got.append(b))
    rt.start()
    table = rt.tables["StockTable"]
    rng = np.random.default_rng(43)
    perm = rng.permutation(T1_ROWS).astype(np.int64)
    sends = t1_sends(np, rng, T1_FILL, fill=True, perm=perm) + \
        t1_sends(np, rng, T1_TIMED, first=T1_FILL)
    price = np.zeros(T1_ROWS, np.float32)
    volume = np.zeros(T1_ROWS, np.int64)
    for mo in mods.values():
        mo.reset_counts()
    lat, t0, heads = [], None, []
    for i, (stream, cols, ts) in enumerate(sends):
        if i == T1_FILL:
            rt.flush()
            t0 = time.perf_counter()
        n0 = len(got)
        tb = time.perf_counter()
        rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
        if i >= T1_FILL:
            if stream == "StockUpdate":
                lat.append(time.perf_counter() - tb)
            else:
                lat[-1] += time.perf_counter() - tb
        if stream == "CheckStock":
            b = got[n0] if len(got) > n0 else None
            heads.append((b["n_valid"], b["n_current"], b["n_dropped"])
                         if b is not None else (0, 0, 0))
            last = b
        got.clear()
    rt.flush()
    wall = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    sub = subcounts(mods)
    # the numpy model, outside the timing: the last writer in batch order
    hj = 0
    for stream, cols, ts in sends:
        if stream == "StockUpdate":
            ids = cols[0]
            _, first_rev = np.unique(ids[::-1], return_index=True)
            last_w = ids.shape[0] - 1 - first_rev
            price[ids[last_w]] = cols[1][last_w]
            volume[ids[last_w]] = cols[2][last_w]
        else:
            n = int((cols[0] < T1_ROWS).sum())
            if heads[hj] != (n, n, 0):
                fail(f"T1 join send {hj}: header {heads[hj]}, numpy "
                     f"({n}, {n}, 0)")
            hj += 1
            want_ids = cols[0]
    v = last["valid"]
    jc = {k: np.asarray(c)[v] for k, c in last["cols"].items()}
    sym = jc["symbol"]
    if not (np.array_equal(np.sort(sym), np.sort(want_ids[want_ids <
                                                        T1_ROWS])) and
            np.array_equal(jc["price"].view(np.int32),
                           price[sym].view(np.int32)) and
            np.array_equal(jc["volume"], volume[sym])):
        fail("T1: the last send's joined rows are not the model's")
    check_launched("T1", launches, plain, ("table_match", "table_write",
                                          "filter_compact", "join_probe"))
    if sub["join_probe index"] <= 0 or sub["table_match_dense"]:
        fail(f"T1: table-mode launches {sub}")
    ev = 2 * T1_B * T1_TIMED
    lat_line(np, "T1 (upsert + enrichment, 2^20-row table)", lat, wall, ev,
             2 * T1_B * (8 + 4 + 8 + 8) + T1_B * (8 + 4 + 8 + 4))
    # the host time of the indexed match and the allocator lookups
    spent = {"match": [0.0, 0], "alloc": [0.0, 0]}
    match, slots_for = table._match, table.allocator.slots_for

    def timed_match(*a, **k):
        t = time.perf_counter()
        out = match(*a, **k)
        spent["match"][0] += time.perf_counter() - t
        spent["match"][1] += 1
        return out

    def timed_slots(*a, **k):
        t = time.perf_counter()
        out = slots_for(*a, **k)
        spent["alloc"][0] += time.perf_counter() - t
        spent["alloc"][1] += 1
        return out
    table._match, table.allocator.slots_for = timed_match, timed_slots
    extra = t1_sends(np, rng, 4, first=T1_FILL + T1_TIMED)

    def send(b):
        for stream, cols, ts in extra[2 * b:2 * b + 2]:
            rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
    profile = device_profile(torch, rt, 4, send)
    table._match, table.allocator.slots_for = match, slots_for
    profile_line("T1", 4, profile)
    print(f"T1 host: TableRuntime._match (the indexed probe, candidates to "
          f"the card, K10's launch) {spent['match'][0] * 1e3 / 4:.3f} ms a "
          f"send over {spent['match'][1]} calls; the primary-key "
          f"allocator's lookups {spent['alloc'][0] * 1e3 / 4:.3f} ms a send "
          f"over {spent['alloc'][1]} calls (upsert match and join probe)")
    # the final table, read back through an on-demand query
    for stream, cols, ts in extra:
        if stream == "StockUpdate":
            ids = cols[0]
            _, first_rev = np.unique(ids[::-1], return_index=True)
            last_w = ids.shape[0] - 1 - first_rev
            price[ids[last_w]] = cols[1][last_w]
            volume[ids[last_w]] = cols[2][last_w]
    rows = rt.query("from StockTable select symbol, price, volume")
    arr = np.array([(e.data[0], e.data[2]) for e in rows], np.int64)
    pr = np.array([e.data[1] for e in rows], np.float32)
    if arr.shape[0] != T1_ROWS or not (
            np.array_equal(np.sort(arr[:, 0]), np.arange(T1_ROWS)) and
            np.array_equal(pr.view(np.int32),
                           price[arr[:, 0]].view(np.int32)) and
            np.array_equal(arr[:, 1], volume[arr[:, 0]])):
        fail("T1: rt.query over StockTable differs from the model")
    print(f"T1 check: every join send's [n_valid, n_current, n_dropped] "
          f"equals numpy's count of probes below 2^20; the last send's "
          f"{sym.shape[0]} joined rows carry the model's price and volume; "
          f"rt.query returns all {T1_ROWS} rows equal to the model; path "
          f"{rt.query_runtimes['enrich'].planned.fastpath}; launches "
          f"{launches}, {sub}")
    mgr.shutdown()
    return launches, sub


def run_t2(torch, np, dev, mods):
    """T2: the table_crud sample whole (no primary key, so every upsert is
    K10's dense mode): 4,096 symbols, 16 sends of 4,096 events (the first a
    permutation, the rest uniform with repeats), the table held to a numpy
    model after every send."""
    from siddhi_tpu_torch import SiddhiManager, convert
    with open("samples/apps/table_crud.siddhi") as fh:
        ql = fh.read()
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(ql)
    rt.start()
    ids = np.array([mgr.interner.intern(f"S{i}") for i in range(T2_SYMS)],
                   np.int32)
    rng = np.random.default_rng(47)
    model = np.full(T2_SYMS, np.nan, np.float32)
    table = rt.tables["PriceTable"]
    for mo in mods.values():
        mo.reset_counts()
    lat = []
    for i in range(T2_SENDS):
        k = rng.permutation(T2_SYMS) if i == 0 else \
            rng.integers(0, T2_SYMS, T2_SYMS)
        pr = (rng.integers(0, 1 << 20, T2_SYMS) / 64).astype(np.float32)
        tb = time.perf_counter()
        rt.get_input_handler("UpdateStream").send_columns(
            [ids[k], pr], timestamps=np.full(T2_SYMS, 1000 + i, np.int64))
        rt.flush()
        lat.append(time.perf_counter() - tb)
        _, first_rev = np.unique(k[::-1], return_index=True)
        last_w = k.shape[0] - 1 - first_rev
        model[k[last_w]] = pr[last_w]
        d = convert.table_to_numpy(table)
        sym, price = d["cols"][0][d["valid"]], d["cols"][1][d["valid"]]
        pos = np.searchsorted(ids, sym) if np.all(np.diff(ids) > 0) else \
            np.array([int(np.nonzero(ids == s)[0][0]) for s in sym])
        if sym.shape[0] != T2_SYMS or np.unique(sym).shape[0] != T2_SYMS \
                or not np.array_equal(price.view(np.int32),
                                      model[pos].view(np.int32)):
            fail(f"T2 send {i}: the table differs from the model")
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("T2", launches, plain, ("table_match", "table_write"))
    if mods["table_match"].dense_launches != launches["table_match"]:
        fail("T2: a match that was not dense")
    ms = np.array(lat) * 1e3
    print(f"T2 (table_crud sample, 4,096 symbols): the table equals the "
          f"numpy model after each of {T2_SENDS} sends; per send (with its "
          f"flush) p50 {float(np.percentile(ms, 50)):.3f} ms, p99 "
          f"{float(np.percentile(ms, 99)):.3f} ms")
    mgr.shutdown()
    return launches, subcounts(mods)


def t3_trace(mgr, ql, actions):
    """One T3 case: per action, the events query 'q' delivered during a
    send, or an on-demand query's rows."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    if "q" in rt.query_runtimes:
        rt.add_callback("q", lambda ts, c, e: got.extend(
            tuple(x.data) for x in c or []))
    rt.start()
    out = []
    for act in actions:
        if act[0] == "query":
            out.append([tuple(e.data) for e in rt.query(act[1])])
        else:
            _, stream, rows, ts = act
            rt.get_input_handler(stream).send(rows, timestamp=ts)
            rt.flush()
            out.append(list(got))
            got.clear()
    mgr.shutdown()
    return out


def run_t3(torch, np, dev, mods):
    """T3: the table corpus's shapes, small, with the events and query
    results the JAX package gives (the CPU tests hold T3_CASES to it)."""
    from siddhi_tpu_torch import SiddhiManager
    for mo in mods.values():
        mo.reset_counts()
    for name, ql, actions, want in T3_CASES:
        got = t3_trace(SiddhiManager(device=dev), ql, actions)
        if got != want:
            fail(f"T3 {name}: {got}, expected {want}")
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    sub = subcounts(mods)
    check_launched("T3", launches, plain, ("table_match", "table_write",
                                          "filter_compact", "join_probe"))
    if sub["table_delete"] <= 0 or sub["join_probe grid"] <= 0 or \
            mods["table_write"].delete_plain_calls:
        fail(f"T3: launches {sub}")
    print(f"T3: {len(T3_CASES)} table-corpus shapes give the JAX package's "
          f"events and query results; launches {launches}, {sub}")
    return launches, sub


def table_phases(torch, np, dev):
    """Phases 18-20: K9, K10 and K7's table modes against their plain
    versions, their times beside their bounds, and T1-T3 through
    SiddhiManager.  Returns the table kernels' records."""
    mods = table_modules()
    err, timing, t1_table = compare_table_kernels(torch, np, dev)
    res = time_table_kernels(torch, np, dev, timing, t1_table)
    del timing, t1_table
    torch.cuda.empty_cache()
    sub = {}
    for run in (run_t1, run_t2, run_t3):
        _, s = run(torch, np, dev, mods)
        for k, v in s.items():
            sub[k] = sub.get(k, 0) + v
    torch.cuda.empty_cache()
    no_write = ("index_put_ is nondeterministic on duplicate indices, and "
                "no call picks the last row of a batch")
    no_match = ("no torch call reduces a bytecode condition over (batch "
                "row, table row) pairs to hit / src / any")
    no_probe = ("no torch call probes a table with a bytecode condition "
                "and compacts pairs and unmatched rows")
    recs = [
        ("table_write", "table_write.cu", "siddhi_tpu/core/table.py:133",
         no_write),
        ("table_delete", "table_write.cu", "siddhi_tpu/core/table.py:144",
         None),
        ("table_match", "table_match.cu", "siddhi_tpu/core/table.py:259",
         no_match),
        ("table_match_dense", "table_match.cu",
         "siddhi_tpu/core/table.py:318", no_match),
        ("join_probe_table", "join_probe.cu", "siddhi_tpu/core/join.py:533",
         no_probe),
        ("join_probe_table_grid", "join_probe.cu",
         "siddhi_tpu/core/join.py:495", no_probe)]
    records = []
    for name, src, rep, why in recs:
        t, n = res[name], sub[name]
        lib = t.get("library_ms")
        why = f"; library_ms null: {why}" if lib is None else ""
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}), plain "
              f"{t['plain_ms']:.4f} ms, launches on the main paths {n}{why}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": lib})
    return records


# ---------------------------------------------------------------------------
# partitioned plain queries: kernel K11 (keyed_window) and K4's run mode;
# output rate limiting (host); P1-P3 and R1 through SiddhiManager
# ---------------------------------------------------------------------------

P1_KEYS = 1 << 20         # P1's devices (@capacity(keys='1048576'))
P1_B = 1 << 17            # P1's events a send
P1_W = 10                 # P1's length(10)
P1_FILL, P1_TIMED = 128, 16   # 128 filling sends: about 16 events a device
P4_SYMS, P4_B = 4096, 1 << 17   # P4's symbols and trades a send
P4_N = 1000               # P4's lengthBatch(1000)
P4_SPREAD, P4_FILL, P4_TIMED = 4, 8, 16   # P4's spreading sends are
                                          # the first of its filling sends
P2_SYMS, P2_PER = 4096, 32   # P2's symbols and events per symbol a send
P2_FILL, P2_TIMED = 8, 16
P2_DT = 250               # ms between P2's sends
K11_OUT = 8 + 4 + 8 + 4   # an emitted row's ts, kind, seq, slot


def partition_modules():
    from siddhi_tpu_torch.kernels import filter_compact, group_agg, \
        keyed_window, post_filter
    return {"keyed_window": keyed_window, "group_agg": group_agg,
            "filter_compact": filter_compact, "post_filter": post_filter}


def p1_send(np, rng, i, n=None):
    """n temperatures (P1's send: 131,072), device ids uniform over
    2^20."""
    n = n or P1_B
    ids = rng.integers(0, P1_KEYS, n).astype(np.int64)
    room = (ids % 97).astype(np.int32)
    temp = (rng.integers(0, 1 << 14, n) / 256).astype(np.float32)
    return [ids, room, temp], np.full(n, 1000 + 10 * i, np.int64)


def p2_send(np, rng, i):
    """32 trades of each of 4,096 symbols, interleaved, at one time."""
    sym = rng.permutation(np.repeat(np.arange(P2_SYMS, dtype=np.int64),
                                    P2_PER))
    vol = rng.integers(1, 100, sym.shape[0]).astype(np.int64)
    return [sym, vol], np.full(sym.shape[0], 1000 + P2_DT * i, np.int64)


def keyed_plan(dev, ql, qname):
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    return rt.query_runtimes[qname].planned


def keyed_args(torch, np, dev, planned, cols=None, ts=None, tick=None):
    """K11's arguments for one send, resolved as the runtime resolves
    them (a range partition's rows keyed by their labels, the rows that
    match no range left out); `tick` (a time): the timer tick over every
    key."""
    from siddhi_tpu_torch.core import event as ev
    if tick is not None:
        staged = ev.pack_np(planned.in_schema, [], capacity=8)
        staged.ts[0], staged.kind[0], staged.valid[0] = tick, ev.TIMER, True
        key_idx, sel = planned.timer_keys()
        gslot = np.zeros(8, np.int32)
        now = tick
    else:
        staged = stage(np, ev, cols, ts)
        lead = []                       # a range partition's labels
        if planned.partition_key_fn is not None:
            lead, kv = planned.partition_key_fn(staged)
            staged = ev.StagedBatch(staged.ts, staged.kind,
                                    staged.valid & kv, staged.cols, staged.n)
            wkeys = list(lead)
        else:
            wkeys = [staged.cols[i] for i in planned.window_key_positions]
        _, ki, sl = planned.window_key_allocator.slots_and_group(
            wkeys, staged.valid, pad=planned.key_capacity)
        key_idx, sel = (torch.from_numpy(x).to(dev) for x in (ki, sl))
        gslot = planned.slot_allocator.slots_for(
            list(lead) + [staged.cols[i] for i in
                          planned.group_by_positions],
            staged.valid) if planned.slot_allocator is not None else \
            np.zeros(staged.ts.shape[0], np.int32)
        now = int(np.asarray(ts).max())
    b = staged.to_device(planned.in_schema, dev)
    from siddhi_tpu_torch.core.planner import _keyed_shape
    t = _keyed_shape(planned.window, planned.name)[2].get("t", 0)
    return (b.ts, b.kind, b.valid, torch.from_numpy(gslot).to(dev), b.cols,
            key_idx, sel, now, t)


def same_bits(torch, x, y):
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.shape == y.shape and bool(torch.equal(x, y))


def slab_err(torch, a, b, what):
    """Two keyed slabs hold the same alive rows and counters, key by key
    (checked on the card; a difference is reported through float_err)."""
    la, lb = a.logical(), b.logical()
    err = 0.0
    for k in la:
        if not same_bits(torch, la[k], lb[k]):
            err = max(err, float_err(torch, la[k], lb[k],
                                     f"{what} slab {k}"))
    return err


def keyed_twin(torch, kw, planned, slabs, args, what, stats, lat=0):
    """One K11 step on slabs[0] and its plain version on slabs[1]: every
    emitted row, the wake and the whole slab compared (exact); `lat` a
    latency session's allowed latency."""
    spec = planned.filter_spec
    ra, wa = kw.launch(slabs[0], spec, *args, tick=False, lat=lat)
    rb, wb = kw.plain(slabs[1], spec, *args, lat=lat)
    torch.cuda.synchronize()
    err = rows_err(torch, ra, rb, what, full=True)
    err = max(err, float_err(torch, wa, wb, f"{what} wake"),
              slab_err(torch, slabs[0], slabs[1], what))
    stats["steps"] += 1
    stats["rows"] += int(ra.ts.shape[0])
    pads = int((args[5] >= planned.key_capacity).sum())
    stats["pads"] += pads
    return err, ra


def compare_keyed_kernel(torch, np, dev):
    """Phase 21: K11 against its plain version, stage by stage, at P1's
    shape (length(10), 2^20 keys; from empty windows, then full ones),
    P2's (time(1 sec), 4,096 keys x 256 rows), P4's (lengthBatch(1000),
    4,096 keys) and a filtered lengthBatch(3): keys interleaved in every
    batch, a key with more events than its capacity and than 64, padding
    key rows, flushes of many keys in one step, TIMER ticks over all K
    keys, out-of-order timestamps (the general time step); then K4's run
    mode against its plain version on a steady P1 send's rows.  Returns
    (max error, the timing inputs)."""
    from siddhi_tpu_torch.kernels import group_agg as ga
    from siddhi_tpu_torch.kernels import keyed_window as kw
    rng = np.random.default_rng(61)
    stats = {"steps": 0, "rows": 0, "pads": 0}
    err = 0.0
    timing = {}
    # -- P1: length(10) over 2^20 keys ---------------------------------------
    p1 = keyed_plan(dev, P1_QL, "p1")
    slab = p1.init_state()[0]
    slabs = [slab, slab.clone()]
    for i in range(2):                      # empty windows: appends only
        cols, ts = p1_send(np, rng, i)
        e, rows = keyed_twin(torch, kw, p1, slabs,
                             keyed_args(torch, np, dev, p1, cols, ts),
                             f"K11 length P1 send {i}", stats)
        err = max(err, e)
    # fill: 16 sends of 2^20 events (about 16 a device) on the kernel alone
    for i in range(2, 18):
        cols, ts = p1_send(np, rng, i, 8 * P1_B)
        kw.launch(slabs[0], p1.filter_spec,
                  *keyed_args(torch, np, dev, p1, cols, ts))
    slabs[1].copy_from(slabs[0])
    for i in range(18, 20):                 # full windows: P1's steady state
        cols, ts = p1_send(np, rng, i)
        args = keyed_args(torch, np, dev, p1, cols, ts)
        if i == 19:
            timing["length"] = (p1, slabs[0].clone(), args)
        e, rows = keyed_twin(torch, kw, p1, slabs, args,
                             f"K11 length P1 send {i}", stats)
        err = max(err, e)
        n_exp = int((rows.kind == 1).sum())
        if n_exp < P1_B // 2:
            fail(f"phase 21: {n_exp} EXPIRED rows at P1's steady state")
    steady, steady_now = rows, int(ts.max())
    cols, ts = p1_send(np, rng, 20)
    cols[0][:100] = 5                       # a hot key: 100 events, C = 10
    e, _ = keyed_twin(torch, kw, p1, slabs,
                      keyed_args(torch, np, dev, p1, cols, ts),
                      "K11 length P1 hot key", stats)
    err = max(err, e)
    # K4's run mode on a steady send's rows, as the selector feeds it
    # (2^20 slots)
    rec = []
    orig = ga.group_agg_scan

    def record(*a, **k):
        rec.append((a, k))
        return orig(*a, **k)
    ga.group_agg_scan = record
    try:
        astate = p1.selector_exec.init_state()
        p1.select_body(astate, steady, steady_now)
    finally:
        ga.group_agg_scan = orig
    (gargs, gkw), = rec
    if not gkw.get("runs"):
        fail("P1's selector did not take group_agg's run mode")
    na_, ra_ = ga.launch(*gargs, runs=True)
    nb_, rb_ = ga.plain(*gargs)
    torch.cuda.synchronize()
    err_ga = 0.0
    for j in range(len(gargs[0])):
        err_ga = max(err_ga, float_err(torch, na_[j], nb_[j], "K4 run state"),
                     float_err(torch, ra_[j], rb_[j], "K4 run rows"))
    timing["group_agg_runs"] = gargs
    del slabs, slab, rows, steady, na_, ra_, nb_, rb_
    # -- P2: time(1 sec) over 4,096 keys, timer ticks over every key ---------
    p2 = keyed_plan(dev, P2_QL, "p2")
    slab = p2.init_state()[0]
    slabs = [slab, slab.clone()]
    for i in range(6):
        now = 1000 + P2_DT * i
        if i >= 4:
            args = keyed_args(torch, np, dev, p2, tick=now)
            if i == 5:
                timing["time_tick"] = (p2, slabs[0].clone(), args)
            e, _ = keyed_twin(torch, kw, p2, slabs, args,
                              f"K11 time P2 tick at {now}", stats)
            err = max(err, e)
        cols, ts = p2_send(np, rng, i)
        args = keyed_args(torch, np, dev, p2, cols, ts)
        if i == 5:
            timing["time"] = (p2, slabs[0].clone(), args)
        e, _ = keyed_twin(torch, kw, p2, slabs, args,
                          f"K11 time P2 send {i}", stats)
        err = max(err, e)
    now = 1000 + P2_DT * 6
    cols, ts = p2_send(np, rng, 6)
    ts = ts - rng.integers(0, 900, ts.shape[0])   # out of order
    cols[0][:300] = 7                       # a hot key above its 256 rows
    for what, args in (
            ("out-of-order hot send",
             keyed_args(torch, np, dev, p2, cols, ts)),
            ("tick", keyed_args(torch, np, dev, p2, tick=now + 400)),
            ("tick expiring every row",
             keyed_args(torch, np, dev, p2, tick=now + 5000))):
        e, _ = keyed_twin(torch, kw, p2, slabs, args, f"K11 time P2 {what}",
                          stats)
        err = max(err, e)
    del slabs, slab
    # -- P4: lengthBatch(1000) over 4,096 symbols -----------------------------
    p4 = keyed_plan(dev, P4_QL, "p4")
    slab = p4.init_state()[0]
    slabs = [slab, slab.clone()]
    for i, (cols, ts) in enumerate(p4_sends(np, rng, P4_SPREAD + 2)):
        args = keyed_args(torch, np, dev, p4, cols, ts)
        if i == P4_SPREAD + 1:
            timing["batch"] = (p4, slabs[0].clone(), args)
        e, rows = keyed_twin(torch, kw, p4, slabs, args,
                             f"K11 lengthBatch P4 send {i}", stats)
        err = max(err, e)
        if i >= P4_SPREAD and not int((rows.kind == 1).sum()):
            fail(f"phase 21: no EXPIRED rows at P4's send {i}")
    del slabs, slab, rows
    # -- lengthBatch(3) with a filter, at P2's traffic ------------------------
    pb = keyed_plan(dev, BATCH21_QL, "b")
    slab = pb.init_state()[0]
    slabs = [slab, slab.clone()]
    for i in range(4):
        cols, ts = p2_send(np, rng, i)
        cols[1] = cols[1] - 10              # about 10% fail `vol >= 0`
        e, _ = keyed_twin(torch, kw, pb, slabs,
                          keyed_args(torch, np, dev, pb, cols, ts),
                          f"K11 lengthBatch send {i}", stats)
        err = max(err, e)
    del slabs, slab
    if stats["pads"] <= 0:
        fail("phase 21 compared no step with padding key rows")
    print(f"compare: keyed_window == plain over {stats['steps']} steps "
          f"({stats['rows']} rows, {stats['pads']} padding key rows; every "
          f"row, wake and slab exact); group_agg run mode == plain on a "
          f"steady P1 send's rows ({gargs[3].shape[0]} rows, "
          f"{gargs[1][0].shape[0]} slots)")
    return max(err, err_ga), timing


def k11_bytes(torch, planned, slab, args, n_out):
    """The bytes one K11 step must move: each arrival read once (ts, kind,
    valid, slot, columns, its sel entry) and written into the slab once,
    each emitted row written once, each slab row that leaves read once,
    each key row's index and counters read and written.  A flushing
    timeBatch key also writes its pending rows into the previous slice."""
    from siddhi_tpu_torch.kernels import keyed_window as kw
    ts, kind, valid, gslot, cols, key_idx, sel = args[:7]
    cb = sum(c.element_size() for c in slab.cols)
    live = key_idx < slab.K
    keep = kw._keep(planned.filter_spec, ts, kind, valid, cols, args[7])
    n_arr = int(((sel >= 0) & keep[sel.clamp(min=0).long()]
                 & live[:, None]).sum())
    kb = int(live.sum())
    if slab.mode == kw.MODE_BATCH:
        # rows read from the slab: the pending and previous rows of every
        # key that flushes
        ki = key_idx[live].long()
        e_k = ((sel[live] >= 0) & keep[sel[live].clamp(min=0).long()]).sum(1)
        fl = (slab.count[ki] + e_k) >= slab.C
        n_leave = int((slab.count[ki] + slab.p_count[ki])[fl].sum())
    elif slab.mode == kw.MODE_TBATCH:
        # the keys whose boundary `now` has passed (from their start, or
        # their first arrival) read both slices and move the pending one
        ki = key_idx[live].long()
        s_l = sel[live]
        ok = (s_l >= 0) & keep[s_l.clamp(min=0).long()]
        a_ts = torch.where(ok, ts[s_l.clamp(min=0).long()], 2 ** 62)
        start0 = slab.key_state["start"][ki]
        started = start0 >= 0
        start = torch.where(started, start0, a_ts.min(1).values)
        el = torch.where(started | ok.any(1), args[7] - start, 0)
        fl = torch.div(el.clamp(min=0), args[8], rounding_mode="floor") > 0
        n_leave = int((slab.count[ki] + slab.p_count[ki])[fl].sum())
        n_arr += int(slab.count[ki][fl].sum())
    else:
        n_leave = n_out - n_arr
    n_read = int((sel >= 0).sum())     # every event is read to filter it
    return (n_read * (8 + 4 + 1 + 4 + 4 + cb) + n_arr * (8 + 4 + cb) +
            n_out * (K11_OUT + cb) + n_leave * (8 + 4 + cb) +
            kb * (4 + 2 * (4 + 4 + 8)))


def time_keyed_kernel(torch, np, dev, timing):
    """Phase 22: K11 per launch by mode (CUDA-graph replays from a restored
    slab), beside its plain version and the bound of the bytes the step
    must move (length at P1's full windows, time at P2's data step and
    tick, lengthBatch at P4's); K4's run mode on a steady P1 send's
    rows."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.kernels import group_agg as ga
    from siddhi_tpu_torch.kernels import keyed_window as kw
    res = {}
    for mode in ("length", "time", "time_tick", "batch"):
        planned, saved, args = timing[mode]
        slab = saved.clone()
        spec = planned.filter_spec

        def restore():
            slab.copy_from(saved)
        restore()
        n_out = int(kw.launch(slab, spec, *args)[0].ts.shape[0])
        nbytes = k11_bytes(torch, planned, saved, args, n_out)
        ms = graph_ms(torch, lambda: kw.launch(slab, spec, *args,
                                               n_out=n_out), 20, restore)
        plain = event_timer(torch, lambda: kw.plain(slab, spec, *args), 3,
                            restore)
        kb = int(args[5].shape[0])
        res[mode] = {"ms": ms, "plain_ms": plain, **bound(nbytes),
                     "shape": f"{kb} key rows, {n_out} rows out"}
        del slab
    # K4's run mode must read each row and write its result, and read and
    # write the state of each slot its contributing rows touch; all K
    # slots only when a RESET row resets them
    gargs = timing["group_agg_runs"]
    _, state, vals, sign, kind, valid, gslot = gargs
    R, K = sign.shape[0], state[0].shape[0]
    vb = sum(v.element_size() for v in vals)
    touched = int(torch.unique(
        torch.where(gslot >= 0, gslot, 0)[sign != 0]).shape[0])
    resets = int((valid & (kind == ev.RESET)).sum())
    state_bytes = (touched + K) * vb if resets else 2 * touched * vb
    res["group_agg_runs"] = {
        "ms": graph_ms(torch, lambda: ga.launch(*gargs, runs=True), 20),
        "plain_ms": event_timer(torch, lambda: ga.plain(*gargs), 2),
        **bound(R * (4 + 4 + 1 + 4 + 2 * vb) + state_bytes),
        "shape": f"{R} rows, {touched} of {K} slots touched, {resets} "
                 f"RESET rows"}
    return res


class P1Model:
    """What P1's rows must hold, kept in numpy: each device's running
    max(temp) (the JAX package's max does not retract expired rows, and
    the port keeps that), its event count, and the timestamp of each of
    its last W events."""

    def __init__(self, np, K, W):
        self.np, self.W = np, W
        self.pmax = np.full(K, -np.inf, np.float32)
        self.cnt = np.zeros(K, np.int64)
        self.ring = np.zeros((K, W), np.int64)   # event p at [p % W]

    def step(self, cols, ts, b=None, what="P1"):
        """Advances the model over one send (every event at time `ts`).
        With `b`, the send's delivered rows, holds every row to it: the
        devices key-major in the order the rows give; per device, in its
        event order, each arrival's CURRENT row (roomNo, deviceID, the
        running max) after the EXPIRED row of the event it pushes out of
        a full window (that event's timestamp, the running max before the
        arrival).  Returns the number of EXPIRED rows."""
        np, W = self.np, self.W
        ids, room, temp = cols
        n = ids.shape[0]
        v = None
        if b is not None:
            v = b["valid"]
            o_dev = b["cols"]["deviceID"][v]
            starts = np.r_[0, np.nonzero(o_dev[1:] != o_dev[:-1])[0] + 1]
            keys = o_dev[starts]
            if np.unique(keys).shape[0] != keys.shape[0]:
                fail(f"{what}: a device's rows are not together "
                     f"(key-major order)")
            rank = np.full(self.cnt.shape[0], -1, np.int64)
            rank[keys] = np.arange(keys.shape[0])
            order = np.lexsort((np.arange(n), rank[ids]))
        else:
            order = np.argsort(ids, kind="stable")
        k = ids[order]
        head = np.ones(n, np.bool_)
        head[1:] = k[1:] != k[:-1]
        seg = np.cumsum(head) - 1
        first = np.nonzero(head)[0]
        a = np.arange(n) - first[seg]              # rank in the device
        # running max per device (temps lie in [0, 64)), from its carry
        off = seg * 128.0
        run = np.maximum.accumulate(temp[order] + off) - off
        run = np.maximum(run.astype(np.float32), self.pmax[k])
        before = np.where(head, self.pmax[k], np.r_[run[:1], run[:-1]])
        c0 = self.cnt[k]
        ev = c0 + a >= W                           # pushes an event out
        q = c0 + a - W                             # ... this one
        e_ts = np.where(q < c0, self.ring[k, q % W], ts)
        pos = np.arange(n) + np.cumsum(ev)         # CURRENT row positions
        pe = pos[ev] - 1
        m = n + int(ev.sum())
        want = {"kind": np.zeros(m, np.int32), "ts": np.empty(m, np.int64),
                "deviceID": np.empty(m, np.int64),
                "roomNo": np.empty(m, np.int32),
                "maxTemp": np.empty(m, np.float32)}
        want["kind"][pe] = 1
        for name, cur, exp in (("ts", ts, e_ts[ev]), ("deviceID", k, k[ev]),
                               ("roomNo", room[order], room[order][ev]),
                               ("maxTemp", run, before[ev])):
            want[name][pos] = cur
            want[name][pe] = exp
        if b is not None:
            got = {"kind": b["kind"][v], "ts": b["ts"][v],
                   **{c: b["cols"][c][v] for c in
                      ("deviceID", "roomNo", "maxTemp")}}
            if got["kind"].shape[0] != m:
                fail(f"{what}: {got['kind'].shape[0]} rows, expected {m} "
                     f"({n} CURRENT, {m - n} EXPIRED)")
            for c in want:
                x, y = got[c], want[c]
                if c == "maxTemp":
                    x, y = x.view(np.int32), y.view(np.int32)
                if not np.array_equal(x, y):
                    bad = np.nonzero(x != y)[0][:3]
                    fail(f"{what}: {c} differs at rows {bad}: {got[c][bad]}"
                         f" vs {want[c][bad]}")
        last = np.r_[first[1:] - 1, n - 1]
        self.pmax[k[last]] = run[last]
        self.ring[k, (c0 + a) % W] = ts
        self.cnt[k[last]] += a[last] + 1
        return m - n


class P4Model:
    """What P4's rows must hold, kept in numpy: each symbol's pending batch
    (prices and timestamps) and the timestamps of its last flushed
    batch."""

    def __init__(self, np, K, N):
        self.np, self.N = np, N
        self.pend = np.zeros((K, N), np.float32)
        self.pts = np.zeros((K, N), np.int64)
        self.pn = np.zeros(K, np.int64)
        self.prev = np.zeros((K, N), np.int64)
        self.has_prev = np.zeros(K, np.bool_)

    def step(self, cols, ts, b=None, what="P4"):
        """Advances the model over one send.  With `b`, the send's
        delivered rows, holds every row to it: each symbol whose batch
        fills, key-major in the order the rows give, emits per flush the
        EXPIRED rows of its previous batch (their timestamps) and then the
        batch's CURRENT rows (their timestamps, the running avg(price)
        over the batch).  The EXPIRED rows' ap follows the reference's
        RESET epochs across symbols; the kernel == plain comparison and
        P3 hold it, not this model.  Returns (flushes, EXPIRED rows)."""
        np, N = self.np, self.N
        sym, price = cols[0], cols[1]
        K = self.pn.shape[0]
        order = np.argsort(sym, kind="stable")
        s_sym, s_p, s_t = sym[order], price[order], ts[order]
        cnt = np.bincount(sym, minlength=K)
        offs = np.r_[0, np.cumsum(cnt)]
        nfl = (self.pn + cnt) // N
        div = np.arange(1, N + 1, dtype=np.float64)
        want, n_exp = {}, 0
        for k in np.nonzero(nfl)[0]:
            pn, lo, hi = self.pn[k], offs[k], offs[k + 1]
            seq_p = np.concatenate([self.pend[k, :pn], s_p[lo:hi]])
            seq_t = np.concatenate([self.pts[k, :pn], s_t[lo:hi]])
            prev = self.prev[k].copy() if self.has_prev[k] else None
            parts = []
            for f in range(nfl[k]):
                bt = seq_t[f * N:(f + 1) * N]
                if prev is not None:
                    parts.append((np.ones(N, np.int32), prev,
                                  np.full(N, np.nan, np.float32)))
                    n_exp += N
                ap = np.cumsum(seq_p[f * N:(f + 1) * N], dtype=np.float64)
                parts.append((np.zeros(N, np.int32), bt,
                              (ap / div).astype(np.float32)))
                prev = bt
            want[int(k)] = [np.concatenate(x) for x in zip(*parts)]
            self.prev[k] = prev
            self.has_prev[k] = True
        a = np.arange(sym.shape[0]) - offs[s_sym]
        rest = self.pn[s_sym] + a - nfl[s_sym] * N
        keep = rest >= 0
        self.pend[s_sym[keep], rest[keep]] = s_p[keep]
        self.pts[s_sym[keep], rest[keep]] = s_t[keep]
        self.pn = (self.pn + cnt) % N
        if b is not None:
            self._check(b, want, what)
        return len(want), n_exp

    def _check(self, b, want, what):
        np = self.np
        v = b["valid"]
        o_sym, o_kind, o_ts = b["cols"]["symbol"][v], b["kind"][v], \
            b["ts"][v]
        o_ap = b["cols"]["ap"][v]
        starts = np.r_[0, np.nonzero(o_sym[1:] != o_sym[:-1])[0] + 1] \
            if o_sym.shape[0] else np.zeros(0, np.int64)
        keys = [int(x) for x in o_sym[starts]]
        if sorted(keys) != sorted(want):
            fail(f"{what}: rows for {len(keys)} symbols, {len(want)} "
                 f"flushed (or a symbol's rows are not together)")
        w_kind, w_ts, w_ap = (np.concatenate([want[k][j] for k in keys])
                              if keys else np.zeros(0) for j in range(3))
        cur = w_kind == 0
        if not (np.array_equal(o_kind, w_kind) and
                np.array_equal(o_ts, w_ts) and
                np.array_equal(o_ap[cur].view(np.int32),
                               w_ap[cur].view(np.int32))):
            fail(f"{what}: kind, ts or ap differs from the numpy model")


def p4_sends(np, rng, n):
    """P4's first n sends.  The first P4_SPREAD hold 1,000 to 1,999 trades
    of each symbol in all, interleaved (at most 2^21 events a send, the
    largest batch), so every symbol flushes once and the symbols' batch
    phases are spread, as in a stream that has run a while; then 131,072
    trades a send, symbols uniform over 4,096.  Prices are dyadic."""
    K, B, N, S = P4_SYMS, P4_B, P4_N, P4_SPREAD
    per = rng.integers(N, 2 * N, K)
    out = []
    for i in range(n):
        if i < S:
            sym = rng.permutation(np.repeat(np.arange(K, dtype=np.int64),
                                            per // S + (i < per % S)))
        else:
            sym = rng.integers(0, K, B).astype(np.int64)
        m = sym.shape[0]
        price = (rng.integers(0, 1 << 14, m) / 256).astype(np.float32)
        vol = rng.integers(1, 100, m).astype(np.int32)
        out.append(([sym, price, vol], np.full(m, 1000 + i, np.int64)))
    return out


def run_p1(torch, np, dev, mods):
    """P1 at full size: 128 filling sends (about 16 events a device, so
    most windows are full and each arrival pushes an event out), every
    row of each held to the numpy model; 16 timed sends; 2 more checked
    sends; then a profiled sweep with the host time of the key grouping
    and the group slots."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(P1_QL)
    got = []
    rt.add_batch_callback("p1", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("TempStream")
    rng = np.random.default_rng(71)
    model = P1Model(np, P1_KEYS, P1_W)
    for mo in mods.values():
        mo.reset_counts()

    def checked_send(i, cols, ts):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        if len(got) != 1:
            fail(f"P1 send {i}: {len(got)} batches")
        return model.step(cols, int(ts[0]), got[0], f"P1 send {i}")
    for i in range(P1_FILL):
        checked_send(i, *p1_send(np, rng, i))
    later = [p1_send(np, rng, i) for i in
             range(P1_FILL, P1_FILL + P1_TIMED + 2 + 8)]
    rt.flush()
    lat = []
    t0 = time.perf_counter()
    for cols, ts in later[:P1_TIMED]:
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        lat.append(time.perf_counter() - tb)
    rt.flush()
    wall = time.perf_counter() - t0
    got.clear()
    for cols, ts in later[:P1_TIMED]:
        model.step(cols, int(ts[0]))
    n_exp = [checked_send(P1_FILL + P1_TIMED + j, *later[P1_TIMED + j])
             for j in range(2)]
    if min(n_exp) < P1_B // 2:
        fail(f"P1: only {n_exp} EXPIRED rows in the checked sends of "
             f"{P1_B} events: the windows are not full")
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("P1", launches, plain, ("keyed_window", "group_agg"))
    kw, ga = mods["keyed_window"], mods["group_agg"]
    if ga.mode_launches[ga.MODE_RUNS] != ga.launches:
        fail(f"P1: group_agg ran {ga.launches - ga.mode_launches[ga.MODE_RUNS]} times "
             f"outside its run mode")
    slab, agg = rt.query_runtimes["p1"].state
    mem = sum(x.numel() * x.element_size() for x in
              list(slab.tensors()) + list(agg))
    print(f"P1: {P1_FILL + 2} sends held row by row to the numpy model "
          f"(key-major order; CURRENT rows with roomNo and the running "
          f"max; the EXPIRED row of each event pushed out, with its "
          f"timestamp); EXPIRED rows in the last checked sends {n_exp} of "
          f"{P1_B} arrivals; device state {mem} bytes (the "
          f"[{slab.K}, {slab.C}] slab and {agg[0].shape[0]} group slots)")
    lat_line(np, "P1", lat, wall, P1_TIMED * P1_B,
             keyed_h2d(np, later[0][0][0], P1_KEYS, 8 + 4 + 4))
    launches_main = (kw.launches, ga.launches)
    host_profile(torch, np, rt, h, later[P1_TIMED + 2:], "P1")
    mgr.shutdown()
    return launches_main


def keyed_h2d(np, keys, K, col_bytes):
    """What one keyed send copies to the card: its columns, ts, kind,
    valid flags and group slots, and the [Kb] key rows and [Kb, E]
    selection its keys group into."""
    from siddhi_tpu_torch.core.keyslots import SlotAllocator
    n = keys.shape[0]
    _, ki, sel = SlotAllocator(K).slots_and_group(
        [keys], np.ones(n, np.bool_), pad=K)
    return n * (col_bytes + 8 + 4 + 1 + 4) + ki.nbytes + sel.nbytes


def host_profile(torch, np, rt, h, sends, label):
    """A profiled sweep, printed: device busy, idle share, top ops, and
    the host time a send of the key grouping (slots_and_group), the group
    slots (slots_for) and, under `@purge`, the purger's ticks (on_timer,
    its resets included)."""
    from siddhi_tpu_torch.core import keyslots
    from siddhi_tpu_torch.core import runtime as rtm
    owners = {"slots_and_group": keyslots.SlotAllocator,
              "slots_for": keyslots.SlotAllocator,
              "on_timer": rtm._PartitionPurger}
    spent = dict.fromkeys(owners, 0.0)
    saved = {n: getattr(c, n) for n, c in owners.items()}

    def timed_fn(name):
        f = saved[name]

        def g(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return f(self, *a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
        return g
    for n, c in owners.items():
        setattr(c, n, timed_fn(n))
    try:
        prof = device_profile(torch, rt, len(sends), lambda b: h.send_columns(
            sends[b][0], timestamps=sends[b][1]))
    finally:
        for n, f in saved.items():
            setattr(owners[n], n, f)
    profile_line(label, len(sends), prof)
    print(f"{label} host (profiled sweep): slots_and_group "
          f"{spent['slots_and_group'] * 1e3 / len(sends):.3f} ms a send, "
          f"slots_for {spent['slots_for'] * 1e3 / len(sends):.3f} ms a send, "
          f"purger ticks {spent['on_timer'] * 1e3 / len(sends):.3f} ms a "
          f"send")


def p2_model(np, sends, i):
    """P2's expected rows for send i: (the TIMER step's EXPIRED rows or
    None, the data step's CURRENT rows), each [4,096, 32] per symbol in
    batch order: (volume sum, count) after the row."""
    V = [c[1][np.argsort(c[0], kind="stable")].reshape(P2_SYMS, P2_PER)
         for c, _ in sends[:i + 1]]
    alive = V[max(0, i - 3):i]
    base = sum(a.sum(1) for a in alive) if alive else np.zeros(P2_SYMS,
                                                               np.int64)
    cnt = P2_PER * len(alive)
    tick = None
    if i >= 4:
        old = V[i - 4]
        pre = base + old.sum(1)
        tick = (pre[:, None] - np.cumsum(old, 1),
                cnt + P2_PER - 1 - np.arange(P2_PER)[None, :].repeat(
                    P2_SYMS, 0))
    cur = (base[:, None] + np.cumsum(V[i], 1),
           cnt + 1 + np.arange(P2_PER)[None, :].repeat(P2_SYMS, 0))
    return tick, cur


def p2_rows_check(np, b, kind, want, what):
    v = b["valid"] & (b["kind"] == kind)
    oc = b["cols"]
    sym, vol, n = oc["symbol"][v], oc["vol"][v], oc["n"][v]
    if sym.shape[0] != P2_SYMS * P2_PER:
        fail(f"P2 {what}: {sym.shape[0]} rows")
    starts = np.r_[0, np.nonzero(sym[1:] != sym[:-1])[0] + 1]
    if starts.shape[0] != P2_SYMS:
        fail(f"P2 {what}: a symbol's rows are not together")
    order = np.argsort(sym, kind="stable")
    if not (np.array_equal(vol[order].reshape(P2_SYMS, P2_PER), want[0])
            and np.array_equal(n[order].reshape(P2_SYMS, P2_PER), want[1])):
        fail(f"P2 {what}: sum(volume) / count() differ from numpy")


def run_p2(torch, np, dev, mods):
    """P2 under playback: sends 250 ms apart, each preceded by a TIMER
    tick over all 4,096 keys that expires the send of 1 s before; 8
    filling sends and 2 after the timed ones checked, every row of both
    steps against numpy's window sums."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(P2_QL)
    got = []
    rt.add_batch_callback("p2", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("TradeStream")
    rng = np.random.default_rng(73)
    n_all = P2_FILL + P2_TIMED + 2
    sends = [p2_send(np, rng, i) for i in range(n_all + 8)]
    for mo in mods.values():
        mo.reset_counts()
    lat, checked = [], 0
    for i, (cols, ts) in enumerate(sends[:n_all]):
        timed = P2_FILL <= i < P2_FILL + P2_TIMED
        if i == P2_FILL:
            rt.flush()
            t0 = time.perf_counter()
        if i == P2_FILL + P2_TIMED:
            rt.flush()
            wall = time.perf_counter() - t0
        got.clear()
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if timed:
            lat.append(time.perf_counter() - tb)
            continue
        tick, cur = p2_model(np, sends, i)
        steps = [b for b in got if b["n_valid"]]
        want_n = 1 + (tick is not None)
        if len(steps) != want_n:
            fail(f"P2 send {i}: {len(steps)} steps emitted, expected "
                 f"{want_n}")
        if tick is not None:
            p2_rows_check(np, steps[0], 1, tick, f"send {i} tick")
        p2_rows_check(np, steps[-1], 0, cur, f"send {i} data")
        checked += 1
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("P2", launches, plain, ("keyed_window", "group_agg"))
    kw = mods["keyed_window"]
    if kw.tick_launches <= 0:
        fail("P2: no timer tick launched K11")
    print(f"P2: {checked} sends held row by row to numpy (the tick's "
          f"EXPIRED rows and the send's CURRENT rows, per symbol); "
          f"K11 launches {kw.launches} ({kw.tick_launches} ticks)")
    ga = mods["group_agg"]
    if ga.mode_launches[ga.MODE_RUNS] != ga.launches:
        fail(f"P2: group_agg ran {ga.launches - ga.mode_launches[ga.MODE_RUNS]} times "
             f"outside its run mode")
    lat_line(np, "P2", lat, wall, P2_TIMED * P2_SYMS * P2_PER,
             keyed_h2d(np, sends[0][0][0], P2_SYMS, 8 + 8))
    launches_main = (kw.launches, ga.launches, kw.tick_launches)
    host_profile(torch, np, rt, h, sends[n_all:], "P2")
    mgr.shutdown()
    return launches_main


def run_p4(torch, np, dev, mods):
    """P4 at full size: 4 spreading sends and 4 more filling sends, every
    row held to the numpy model; 16 timed sends; 2 more checked sends;
    then a profiled sweep with the host time of the key grouping and the
    group slots."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(P4_QL)
    got = []
    rt.add_batch_callback("p4", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("StockStream")
    rng = np.random.default_rng(77)
    model = P4Model(np, P4_SYMS, P4_N)
    for mo in mods.values():
        mo.reset_counts()

    def checked_send(i, cols, ts):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        steps = [b for b in got if b["n_valid"]]
        if len(steps) > 1:
            fail(f"P4 send {i}: {len(steps)} steps emitted")
        if not steps:                       # no batch filled
            out = model.step(cols, ts)
            if out[0]:
                fail(f"P4 send {i}: no rows, {out[0]} flushes expected")
            return out
        return model.step(cols, ts, steps[0], f"P4 send {i}")
    sends = p4_sends(np, rng, P4_FILL + P4_TIMED + 2 + 8)
    for i in range(P4_FILL):
        checked_send(i, *sends[i])
    later = sends[P4_FILL:]
    rt.flush()
    lat = []
    t0 = time.perf_counter()
    for cols, ts in later[:P4_TIMED]:
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        lat.append(time.perf_counter() - tb)
    rt.flush()
    wall = time.perf_counter() - t0
    got.clear()
    flushes = [model.step(cols, ts)[0] for cols, ts in later[:P4_TIMED]]
    last = [checked_send(P4_FILL + P4_TIMED + j, *later[P4_TIMED + j])
            for j in range(2)]
    if min(e for _, e in last) <= 0:
        fail(f"P4: no EXPIRED rows in the checked sends ({last})")
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("P4", launches, plain, ("keyed_window", "group_agg"))
    kw, ga = mods["keyed_window"], mods["group_agg"]
    if ga.mode_launches[ga.MODE_RUNS] != ga.launches:
        fail(f"P4: group_agg ran {ga.launches - ga.mode_launches[ga.MODE_RUNS]} times "
             f"outside its run mode")
    slab, agg = rt.query_runtimes["p4"].state
    mem = sum(x.numel() * x.element_size() for x in
              list(slab.tensors()) + list(agg))
    print(f"P4: {P4_FILL + 2} sends held row by row to the numpy model "
          f"(key-major order; each flush's EXPIRED rows with their "
          f"timestamps, its CURRENT rows with the running avg); flushes a "
          f"timed send {min(flushes)}-{max(flushes)}, (flushes, EXPIRED "
          f"rows) of the last checked sends {last}; device state {mem} "
          f"bytes (the [{slab.K}, {slab.C}] slab and {agg[0].shape[0]} "
          f"group slots)")
    lat_line(np, "P4", lat, wall, P4_TIMED * P4_B,
             keyed_h2d(np, later[0][0][0], P4_SYMS, 8 + 4 + 4))
    launches_main = (kw.mode_launches[kw.MODE_BATCH], ga.launches)
    host_profile(torch, np, rt, h, later[P4_TIMED + 2:], "P4")
    mgr.shutdown()
    return launches_main


def corpus_run(mgr, ql, qname, sends):
    """Events of one small case: per callback (ts, [(ts, current row)],
    [(ts, expired row)])."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback(qname, lambda ts, i, o: got.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
         [(e.timestamp, tuple(e.data)) for e in o or []])))
    rt.start()
    for stream, rows, ts in sends:
        rt.get_input_handler(stream).send(rows, timestamp=ts)
    rt.flush()
    mgr.shutdown()
    return got


def run_corpus(torch, np, dev, mods, label, cases, which):
    """P3 / R1: small cases with the events the JAX package gives (the CPU
    tests hold the cases to it)."""
    from siddhi_tpu_torch import SiddhiManager
    for mo in mods.values():
        mo.reset_counts()
    for name, ql, qname, sends, want in cases:
        got = corpus_run(SiddhiManager(device=dev), ql, qname, sends)
        if got != want:
            fail(f"{label} {name}: {got}, expected {want}")
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched(label, launches, plain, which)
    print(f"{label}: {len(cases)} cases give the JAX package's events")
    return launches


def partition_phases(torch, np, dev):
    """Phases 21-24: K11 (and K4's run mode) against their plain versions,
    their times beside their bounds, P1-P4 through SiddhiManager, and R1.
    Returns the kernel records: each mode's time at the shape of the
    configuration whose launches it reports (length P1, time P2,
    lengthBatch P4)."""
    from siddhi_tpu_torch.kernels import block_nfa, join_probe
    mods = partition_modules()
    err, timing = compare_keyed_kernel(torch, np, dev)
    res = time_keyed_kernel(torch, np, dev, timing)
    del timing
    torch.cuda.empty_cache()
    l1_kw, l1_ga = run_p1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    l2_kw, l2_ga, ticks = run_p2(torch, np, dev, mods)
    torch.cuda.empty_cache()
    l4_batch, l4_ga = run_p4(torch, np, dev, mods)
    torch.cuda.empty_cache()
    run_corpus(torch, np, dev, mods, "P3", P3_CASES,
               ("keyed_window", "group_agg", "filter_compact"))
    kw = mods["keyed_window"]
    l3_batch = kw.mode_launches[kw.MODE_BATCH]
    print(f"P3: K11 lengthBatch launches {l3_batch}")
    rmods = dict(mods, block_nfa=block_nfa, join_probe=join_probe)
    run_corpus(torch, np, dev, rmods, "R1", R1_CASES,
               ("keyed_window", "group_agg", "filter_compact", "block_nfa",
                "join_probe"))
    launches = {"length": l1_kw, "time": l2_kw - ticks, "time_tick": ticks,
                "batch": l4_batch}
    why = "no single PyTorch call computes a per-key window step"
    records = []
    for mode, name in (("length", "keyed_window"),
                       ("time", "keyed_window_time"),
                       ("time_tick", "keyed_window_time_tick"),
                       ("batch", "keyed_window_batch"),
                       ("group_agg_runs", "group_agg_runs")):
        t = res[mode]
        n = l1_ga + l2_ga + l4_ga if mode == "group_agg_runs" else \
            launches[mode]
        src = "group_agg.cu" if mode == "group_agg_runs" else \
            "keyed_window.cu"
        rep = "siddhi_tpu/core/selector.py:320" \
            if mode == "group_agg_runs" else "siddhi_tpu/core/planner.py:539"
        lib_why = ("no single PyTorch call computes a segmented scan with "
                   "carry state") if mode == "group_agg_runs" else why
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} "
              f"bytes), plain {t['plain_ms']:.4f} ms, launches on the main "
              f"paths {n}; library_ms null: {lib_why}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    return records


# bench.py:297 config_sequence_within (siddhi_tpu/analysis/corpus.py
# SEQUENCE_QL); S1-wide raises the @emit cap with its batch
S1_QL = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(keys='1', slots='8')
@emit(rows='{rows}')
@info(name='q')
from every e1=S[volume == 1], e2=S[volume == 2 and price > e1.price]
  within 1 sec
select e1.price as p1, e2.price as p2
insert into M;
"""

NON_EVERY_SEQ_QL = """
@app:playback
define stream S (symbol long, price float, volume int);
@info(name='q')
from e1=S[volume == 2], e2=S[price >= 0.0]
select e1.price as p1, e2.price as p2
insert into M;
"""

OVERFLOW_QL = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(slots='2')
@info(name='q')
from every e1=S[volume == 1] -> e2=S[volume == 2 and price > e1.price]
     -> e3=S[volume == 3] within 100 milliseconds
select e1.price as p1, e2.price as p2, e3.volume as v3
insert into M;
"""

# K8's edge cases (phase 14 and tests/test_torch_pattern_block.py): where a
# row's first match lies past event 96 of its chunk, where most seeds never
# match, where `within` cuts inside a chunk, and a sequence over runs of
# more than 32 invalid rows
_K8_HEAD = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(slots='8')
@info(name='q')
"""
K8_EDGE_CASES = {
    "late first match": _K8_HEAD + """
from every e1=S[volume == 1] -> e2=S[volume == 3 and price >= e1.price]
select e1.price as p1, e2.price as p2 insert into M;""",
    "falling prices": _K8_HEAD + """
from every e1=S[volume == 1] -> e2=S[price > e1.price] within 10 sec
select e1.price as p1, e2.price as p2 insert into M;""",
    "within inside a chunk": _K8_HEAD + """
from every e1=S[volume == 1] -> e2=S[volume == 2 and price > e1.price]
     -> e3=S[volume == 3] within 20 milliseconds
select e1.price as p1, e2.price as p2, e3.price as p3 insert into M;""",
    "invalid runs": _K8_HEAD + """
from every e1=S[volume == 1], e2=S[volume == 2 and price > e1.price]
  within 1 sec
select e1.price as p1, e2.price as p2 insert into M;""",
}


K8_EDGE_E = 8192


def k8_edge_send(np, rng, case, E, i):
    """Send i of a K8 edge case: (columns, ts, selection i32[E], -1 for an
    invalid row).  "late first match": in each 128-event chunk, events 0-15
    seed (volume 1), 16-99 never match (volume 2), 100-127 may (volume 3).
    "falling prices": prices falling over the send, 1% of them risen at
    random, half the events seeds.  "within inside a chunk": 1 ms an event,
    volume 2 rare, so most pairs lie past the 20 ms cut.  "invalid runs":
    S1's alternating volumes with a run of 33-70 invalid rows in each
    chunk."""
    pos = np.arange(E) % 128
    price = rng.random(E, np.float32)
    ts = 1000 + 2 * E * i + np.arange(E, dtype=np.int64)
    sel = np.arange(E, dtype=np.int32)
    if case == "late first match":
        vol = np.where(pos < 16, 1, np.where(pos < 100, 2, 3))
    elif case == "falling prices":
        price = np.linspace(1.0, 0.0, E, dtype=np.float32)
        up = rng.random(E) < 0.01
        price[up] = rng.random(int(up.sum()), np.float32)
        vol = rng.integers(1, 3, E)
    elif case == "within inside a chunk":
        vol = rng.choice([1, 2, 3], E, p=[0.3, 0.05, 0.65])
    else:
        vol = np.tile(np.array([1, 2]), E // 2 + 1)[:E]
        for c0 in range(0, E, 128):
            n = int(rng.integers(33, 71))
            a = c0 + int(rng.integers(0, 128 - n // 2))
            sel[a:a + n] = -1
    return ([np.zeros(E, np.int64), price, vol.astype(np.int32)], ts, sel)


# tests/test_correctness_fixes.py ABSENT_QL with `every`, at 2^20 keys
A1_QL = """
@app:playback
define stream S1 (key long, v int);
define stream S2 (key long, v int);
partition with (key of S1, key of S2)
begin
  @capacity(keys='1048576', slots='4')
  @info(name='q')
  from every e1=S1[v == 1] -> not S2 for 1 sec
  select e1.key as k
  insert into Out;
end;
"""

# tests/test_absent_corpus.py: its stream definitions and the shapes with
# standalone absent atoms, with the events the JAX package gives
A2_BASE = """
@app:playback
define stream S1 (sym string, price float, vol int);
define stream S2 (sym string, price float, vol int);
define stream S3 (sym string, price float, vol int);
"""
A2_CASES = [
    ("absent filter suppresses", """
@info(name='q') from e1=S1[price > 20.0] ->
    not S2[price > e1.price] for 1 sec
select e1.sym as a insert into Out;
""", [("S1", ["WSO2", 55.6, 100], 1000), ("S2", ["IBM", 58.7, 10], 1100),
      ("S1", ["tick", 99.0, 1], 2500)], []),
    ("non-matching arrival", """
@info(name='q') from e1=S1[price > 20.0] ->
    not S2[price > e1.price] for 1 sec
select e1.sym as a insert into Out;
""", [("S1", ["WSO2", 55.6, 100], 1000), ("S2", ["IBM", 45.7, 10], 1100),
      ("S1", ["tick", 9.0, 1], 2500)], [("WSO2",)]),
    ("arrival after the wait", """
@info(name='q') from e1=S1[price > 20.0] ->
    not S2[price > e1.price] for 1 sec
select e1.sym as a insert into Out;
""", [("S1", ["WSO2", 55.6, 100], 1000), ("S2", ["IBM", 58.7, 10], 2100)],
     [("WSO2",)]),
    ("two-stage chain", """
@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2] ->
    not S3[vol == 3] for 1 sec
select e1.sym as a, e2.sym as b insert into Out;
""", [("S1", ["a", 1.0, 1], 1000), ("S2", ["b", 1.0, 2], 1200),
      ("S1", ["tick", 1.0, 9], 2600)], [("a", "b")]),
    ("two-stage chain violated", """
@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2] ->
    not S3[vol == 3] for 1 sec
select e1.sym as a, e2.sym as b insert into Out;
""", [("S1", ["a", 1.0, 1], 1000), ("S2", ["b", 1.0, 2], 1200),
      ("S3", ["c", 1.0, 3], 1900), ("S1", ["tick", 1.0, 9], 2600)], []),
    ("absent then presence", """
@info(name='q') from e1=S1[vol == 1] -> not S2 for 1 sec ->
    e3=S3[vol == 3]
select e1.sym as a, e3.sym as c insert into Out;
""", [("S1", ["a", 1.0, 1], 1000), ("S3", ["early", 1.0, 3], 1500),
      ("S3", ["c", 1.0, 3], 2400)], [("a", "c")]),
    ("every absent per seed", """
@info(name='q') from every e1=S1[vol == 1] -> not S2 for 1 sec
select e1.sym as a insert into Out;
""", [("S1", ["a", 1.0, 1], 1000), ("S1", ["b", 1.0, 1], 1400),
      ("S1", ["tick", 1.0, 9], 3000)], [("a",), ("b",)]),
    ("every absent partial suppression", """
@info(name='q') from every e1=S1[vol == 1] -> not S2 for 1 sec
select e1.sym as a insert into Out;
""", [("S1", ["a", 1.0, 1], 1000), ("S1", ["b", 1.0, 1], 1800),
      ("S2", ["kill", 1.0, 2], 1900), ("S1", ["tick", 1.0, 9], 3500)], []),
    ("absent within", """
@info(name='q') from e1=S1[vol == 1] -> not S2 for 2 sec
    within 1 sec
select e1.sym as a insert into Out;
""", [("S1", ["a", 1.0, 1], 1000), ("S1", ["tick", 1.0, 9], 4000)], []),
]

# tests/test_playback_idle.py:51 (idle advance fires an absent pattern)
A2_IDLE_QL = """
@app:playback(idle.time = '50 millisec', increment = '300 millisec')
define stream S1 (sym string, price float);
define stream S2 (sym string, price float);
@info(name='q') from e1=S1[price > 20.0] -> not S2 for 1 sec
select e1.sym as a insert into Out;
"""
A2_IDLE_WANT = [("WSO2",)]


# bench.py:261 config_windowed_join (siddhi_tpu/analysis/corpus.py
# WINDOWED_JOIN_QL)
J1_QL = """
@app:playback
define stream L (symbol long, price float);
define stream R (symbol long, qty int);
@emit(rows='65536')
@info(name='q')
from L#window.length(128) join R#window.length(128)
  on L.symbol == R.symbol
select L.symbol as s, L.price as p, R.qty as v
insert into Out;
"""

# samples/apps/outer_join_enrichment.siddhi's first query with 2^20-row
# windows and long ids
J2_QL = """
@app:playback
define stream Orders (id long, price float);
define stream Fills (id long, qty int);
@info(name='enrich')
from Orders#window.length(1048576) left outer join Fills#window.length(1048576)
  on Orders.id == Fills.id
select Orders.id as id, price, qty
insert into Enriched;
"""

# small joins for the kernel comparison: (what, query, {send: TIMER time})
_SMALL = """
@app:playback
define stream L (symbol long, price float, flag bool);
define stream R (symbol long, qty int);
@info(name='q')
from L{fl}#window.{wl} {jt} R#window.{wr}
  on {on}
select L.symbol as s, price, qty {having} insert into Out;
"""
SMALL_JOINS = [
    ("full outer, time(1 sec) against length(64), TIMER steps, having",
     _SMALL.format(fl="", wl="time(1 sec)", jt="full outer join",
                   wr="length(64)", on="L.symbol == R.symbol",
                   having="having coalesce(qty, 0) > 2 or price > 0.5"),
     {4: 2390, 10: 4490}),
    ("left outer, side filter (grid), batches longer than the windows",
     _SMALL.format(fl="[price > 0.2 and not flag]", wl="length(100)",
                   jt="left outer join", wr="length(50)",
                   on="L.symbol == R.symbol and price < 0.9", having=""),
     {}),
    ("right outer, non-equi ON (grid), time sides",
     _SMALL.format(fl="", wl="time(800)", jt="right outer join",
                   wr="time(1 sec)", on="L.symbol < R.symbol - 30",
                   having=""), {8: 3790}),
]


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


# The Siddhi 5.1 query guide's "Table" section: a @PrimaryKey table written
# by `update or insert into ... on T.key == key` and read by a stream-table
# join, with its StockTable (symbol, price, volume) shape; `symbol` is a
# LONG id (not a STRING) so that interning 2^20 strings does not measure
# the interner
T1_QL = """
define stream StockUpdate (symbol long, price float, volume long);
define stream CheckStock (symbol long, qty int);
@PrimaryKey('symbol') @capacity(rows='1048576')
define table StockTable (symbol long, price float, volume long);
@info(name='upsert') from StockUpdate select symbol, price, volume
update or insert into StockTable on StockTable.symbol == symbol;
@info(name='enrich') from CheckStock join StockTable
  on CheckStock.symbol == StockTable.symbol
select CheckStock.symbol, CheckStock.qty, StockTable.price,
       StockTable.volume
insert into Enriched;
"""

# phase 18's twins: a keyless table with inserts, deletes and an upsert
# (freed-row reuse, the masked delete, K10 dense) and stream-table joins on
# the grid, inner and left outer
CRUD18_QL = """
define stream Ins (sym int, price float);
define stream Del (sym int);
define stream Ups (sym int, price float);
define stream Probe (sym int);
@capacity(rows='8192')
define table PriceTable (sym int, price float);
@info(name='ins') from Ins insert into PriceTable;
@info(name='del') from Del delete PriceTable on PriceTable.sym == sym;
@info(name='ups') from Ups select sym, price
update or insert into PriceTable on PriceTable.sym == sym;
@info(name='inner') from Probe join PriceTable
  on Probe.sym == PriceTable.sym
select Probe.sym as s, PriceTable.price as p insert into O1;
@info(name='outer') from Probe left outer join PriceTable
  on Probe.sym == PriceTable.sym
select Probe.sym as s, PriceTable.price as p insert into O2;
"""

BIG18_QL = """
define stream In (k long, v int);
define stream Up (k long, v int);
@capacity(rows='1048576')
define table T (k long, v int);
@info(name='w') from In insert into T;
@info(name='u') from Up update T set T.v = v on T.k == k;
"""

IDX18_QL = """
define stream In (k long, grp int, v int);
define stream Del (grp int, v int);
@PrimaryKey('k') @Index('grp') @capacity(rows='65536')
define table T (k long, grp int, v int);
@info(name='w') from In insert into T;
@info(name='d') from Del delete T on T.grp == grp and T.v > v;
"""

# T3: the shapes of tests/test_table_join.py, test_table_pk_matrix.py,
# test_table_index.py, test_ondemand_corpus2.py and test_join_fastpath.py's
# table cases, with the events and query results the JAX package gives
_T3_JOIN = """
@app:playback
define stream S (sym long, price float);
define stream Feed (sym long, name long);
{ann}
define table T (sym long, name long);
@info(name='load') from Feed select sym, name insert into T;
@info(name='q')
from S{win} {jt} T on S.sym == T.sym{residual}
select S.sym as s, price, T.name as n insert into Out;
"""
_T3_FEED = [("send", "Feed", [[1, 10], [2, 20], [3, 30], [5, 50], [2, 21]],
             1000),
            ("send", "S", [[1, 0.5], [2, 0.25], [4, 0.75], [5, 0.125],
                           [2, 0.875]], 1001),
            ("send", "Feed", [[4, 40], [6, 60]], 1002),
            ("send", "S", [[4, 0.5], [6, 0.0625], [7, 0.5], [1, 0.375]],
             1003)]
_T3_SPECS = [
    ("crud (test_table_join.py)", """
@app:playback
define stream S (symbol string, price float);
define stream DeleteStream (symbol string);
define stream U (symbol string, newPrice float);
define stream UI (symbol string, price float);
define table T (symbol string, price float);
from S select * insert into T;
from DeleteStream delete T on T.symbol == symbol;
from U select symbol, newPrice
update T set T.price = newPrice on T.symbol == symbol;
from UI update or insert into T set T.price = price on T.symbol == symbol;
""", [("send", "S", [["A", 1.0], ["B", 2.0], ["C", 3.0]], 1000),
      ("send", "DeleteStream", [["B"]], 1001),
      ("send", "U", [["A", 9.5]], 1002),
      ("send", "UI", [["D", 4.0], ["A", 2.0], ["D", 5.0]], 1003),
      ("query", "from T select symbol, price")]),
    ("primary key, long (test_table_pk_matrix.py)", """
@app:playback
define stream In (sym long, price double, vol long);
define stream Del (k long);
define stream Upd (k long, p double);
@PrimaryKey('sym')
define table T (sym long, price double, vol long);
@info(name='ins') from In select sym, price, vol insert into T;
@info(name='del') from Del delete T on T.sym == k;
@info(name='upd') from Upd update T set T.price = p on T.sym == k;
""", [("send", "In", [[10, 0.0, 0], [20, 1.0, 10], [30, 2.0, 20],
                      [10, 3.0, 30], [40, 4.0, 40], [20, 5.0, 50]], 1000),
      ("send", "Upd", [[20, 99.5]], 1001),
      ("send", "Del", [[10]], 1002),
      ("send", "In", [[50, 6.0, 60], [50, 7.0, 70], [10, 8.0, 80]], 1003),
      ("query", "from T select sym, price, vol")]),
    ("@Index on-demand conditions (test_table_index.py)", """
@app:playback
define stream In (k string, sym string, v int);
@PrimaryKey('k')
@Index('sym', 'v')
define table T (k string, sym string, v int);
@info(name='w') from In insert into T;
""", [("send", "In", [[f"k{i}", f"s{i % 4}", i] for i in range(16)], 1000),
      ("query", "from T on sym == 's2' select k, v"),
      ("query", "from T on v >= 12 select k, v"),
      ("query", "from T on sym == 's1' and v > 6 select k, v"),
      ("query", "from T on v == 5.5 select k"),
      ("query", "from T on v < 3 or sym == 's3' select k, v")]),
    ("@PrimaryKey + @Index delete / update (test_table_index.py)", """
@app:playback
define stream In (k string, sym string, v int);
define stream Del (sym string);
define stream Up (sym string, v int);
@PrimaryKey('k')
@Index('sym')
define table T (k string, sym string, v int);
@info(name='w') from In insert into T;
@info(name='d') from Del delete T on T.sym == sym;
@info(name='u') from Up update T set T.v = v on T.sym == sym;
""", [("send", "In", [[f"k{i}", f"s{i % 3}", i] for i in range(8)], 1000),
      ("send", "Del", [["s1"]], 1001),
      ("send", "Up", [["s2", 77], ["s0", 5]], 1002),
      ("query", "from T select k, sym, v")]),
    ("join, @PrimaryKey fast path (test_join_fastpath.py)",
     _T3_JOIN.format(ann="@PrimaryKey('sym')", win="", jt="join",
                     residual=""), _T3_FEED),
    ("join, @Index fast path with a residual", _T3_JOIN.format(
        ann="@Index('sym')", win="", jt="join",
        residual=" and S.price > 0.3"), _T3_FEED),
    ("left outer join, @PrimaryKey fast path", _T3_JOIN.format(
        ann="@PrimaryKey('sym')", win="", jt="left outer join",
        residual=""), _T3_FEED),
    ("join, unindexed table (grid)", _T3_JOIN.format(
        ann="", win="", jt="join", residual=""), _T3_FEED),
    ("full outer join, windowed stream side (grid)", _T3_JOIN.format(
        ann="", win="#window.length(2)", jt="full outer join",
        residual=""), _T3_FEED),
    ("on-demand writes (test_ondemand_corpus2.py)", """
@app:playback
define stream In (sym string, price double, qty int);
define table T (sym string, price double, qty int);
@info(name='w') from In insert into T;
""", [("send", "In", [["a", 10.0, 5], ["b", 20.0, 3], ["c", 30.0, 8],
                      ["d", 5.0, 1]], 1000),
      ("query", "from T on T.sym == 'b' select 'b' as sym, 99.0 as price, "
                "7 as qty update or insert into T set T.price = price, "
                "T.qty = qty on T.sym == sym"),
      ("query", "from T on T.sym == 'a' select 'zz' as sym, 1.0 as price, "
                "2 as qty update or insert into T set T.price = price, "
                "T.qty = qty on T.sym == sym"),
      ("query", "from T on T.qty > 2 select sym update T set T.price = "
                "T.price * 2.0 on T.sym == sym"),
      ("query", "from T delete T on T.sym == 'c'"),
      ("query", "select 'e' as sym, 1.5 as price, 4 as qty insert into T"),
      ("query", "from T select sym, price, qty"),
      ("query", "from T select qty, sum(price) as total group by qty "
                "order by total desc limit 2")]),
    ("set expressions read the old columns", """
@app:playback
define stream In (k long, a int, b int);
define stream Sw (k long);
@PrimaryKey('k')
define table T (k long, a int, b int);
from In insert into T;
from Sw update T set T.a = T.b, T.b = T.a on T.k == k;
""", [("send", "In", [[1, 10, 20], [2, 30, 40], [3, 50, 60]], 1000),
      ("send", "Sw", [[1], [3]], 1001),
      ("send", "Sw", [[3]], 1002),
      ("query", "from T select k, a, b")]),
]

_T3_WANT = [
    # crud (test_table_join.py)
    [[], [], [], [], [('A', 2.0), ('D', 4.0), ('C', 3.0), ('D', 5.0)]],
    # primary key, long (test_table_pk_matrix.py)
    [[], [], [], [],
     [(50, 7.0, 70), (20, 99.5, 50), (30, 2.0, 20), (40, 4.0, 40),
      (10, 8.0, 80)]],
    # @Index on-demand conditions (test_table_index.py)
    [[], [('k2', 2), ('k6', 6), ('k10', 10), ('k14', 14)],
     [('k12', 12), ('k13', 13), ('k14', 14), ('k15', 15)],
     [('k9', 9), ('k13', 13)], [],
     [('k0', 0), ('k1', 1), ('k2', 2), ('k3', 3), ('k7', 7), ('k11', 11),
      ('k15', 15)]],
    # @PrimaryKey + @Index delete / update (test_table_index.py)
    [[], [], [],
     [('k0', 's0', 5), ('k2', 's2', 77), ('k3', 's0', 5), ('k5', 's2', 77),
      ('k6', 's0', 5)]],
    # join, @PrimaryKey fast path (test_join_fastpath.py)
    [[], [(1, 0.5, 10), (2, 0.25, 21), (5, 0.125, 50), (2, 0.875, 21)], [],
     [(4, 0.5, 40), (6, 0.0625, 60), (1, 0.375, 10)]],
    # join, @Index fast path with a residual
    [[], [(1, 0.5, 10), (2, 0.875, 20), (2, 0.875, 21)], [],
     [(4, 0.5, 40), (1, 0.375, 10)]],
    # left outer join, @PrimaryKey fast path
    [[],
     [(1, 0.5, 10), (2, 0.25, 21), (5, 0.125, 50), (2, 0.875, 21),
      (4, 0.75, None)],
     [], [(4, 0.5, 40), (6, 0.0625, 60), (1, 0.375, 10), (7, 0.5, None)]],
    # join, unindexed table (grid)
    [[],
     [(1, 0.5, 10), (2, 0.25, 20), (2, 0.25, 21), (5, 0.125, 50),
      (2, 0.875, 20), (2, 0.875, 21)],
     [], [(4, 0.5, 40), (6, 0.0625, 60), (1, 0.375, 10)]],
    # full outer join, windowed stream side (grid)
    [[],
     [(1, 0.5, 10), (2, 0.25, 20), (2, 0.25, 21), (5, 0.125, 50),
      (2, 0.875, 20), (2, 0.875, 21), (4, 0.75, None)],
     [], [(4, 0.5, 40), (6, 0.0625, 60), (1, 0.375, 10), (7, 0.5, None)]],
    # on-demand writes (test_ondemand_corpus2.py)
    [[], [('b', 99.0, 7)], [('zz', 1.0, 2)], [('a',), ('b',), ('c',)],
     [('a', 20.0, 5), ('b', 198.0, 7), ('c', 60.0, 8), ('d', 5.0, 1),
      ('zz', 1.0, 2)],
     [('e', 1.5, 4)],
     [('a', 20.0, 5), ('b', 198.0, 7), ('e', 1.5, 4), ('d', 5.0, 1),
      ('zz', 1.0, 2)],
     [(7, 198.0), (5, 20.0)]],
    # set expressions read the old columns
    [[], [], [], [(1, 20, 10), (2, 30, 40), (3, 50, 60)]],
]
T3_CASES = [(name, ql, actions, want) for (name, ql, actions), want
            in zip(_T3_SPECS, _T3_WANT)]

# P1: the Siddhi 5.1 query guide's "Partition" example (per-device rolling
# maximum over a length(10) window) at 2^20 devices
P1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (deviceID of TempStream)
begin
  @capacity(keys='1048576')
  @info(name='p1')
  from TempStream#window.length(10)
  select roomNo, deviceID, max(temp) as maxTemp
  insert into DeviceTempStream;
end;
"""
# P2: per-symbol 1-second volume with its timer ticks
P2_QL = """
@app:playback
define stream TradeStream (symbol long, volume long);
partition with (symbol of TradeStream)
begin
  @capacity(keys='4096', window='256')
  @info(name='p2')
  from TradeStream#window.time(1 sec)
  select symbol, sum(volume) as vol, count() as n
  insert all events into SymbolVolume;
end;
"""
# P4: per-symbol batch average (bench.py's config 2, partitioned by symbol)
P4_QL = """
@app:playback
define stream StockStream (symbol long, price float, volume int);
partition with (symbol of StockStream)
begin
  @capacity(keys='4096')
  @info(name='p4')
  from StockStream#window.lengthBatch(1000)
  select symbol, avg(price) as ap
  insert into OutputStream;
end;
"""
# phase 21's filtered lengthBatch at P2's traffic
BATCH21_QL = """
@app:playback
define stream TradeStream (symbol long, volume long);
partition with (symbol of TradeStream)
begin
  @capacity(keys='4096')
  @info(name='b')
  from TradeStream[volume >= 0]#window.lengthBatch(3)
  select symbol, sum(volume) as vol, count() as n
  insert all events into BatchOut;
end;
"""

_KEYED = """
@app:playback
define stream S (k long, v float, w int);
partition with (k of S)
begin
  @capacity(keys='64')
  @info(name='q') from S[w >= 0]#window.{win}
  select k, sum(v) as sv, count() as c, max(w) as mw
  insert all events into Out;
end;
"""


def _rows(seed, n_sends, per, n_keys, t0=1000, dt=250):
    """Small interleaved sends: (stream, rows, ts) with several keys each."""
    import random
    r = random.Random(seed)
    out = []
    for i in range(n_sends):
        rows = [[r.randrange(n_keys), r.randrange(64) / 64.0,
                 r.randrange(-1, 9)] for _ in range(per)]
        out.append(("S", rows, t0 + dt * i))
    return out


def _sample_text(name):
    """A sample app of the repository ('' where the script stands alone)."""
    import os
    p = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples",
                     "apps", name)
    if not os.path.exists(p):
        return ""
    with open(p) as fh:
        return fh.read()


_SYM3 = [("S", ["IBM", 1.0, 1], 1000), ("S", ["WSO2", 1.0, 1], 1001),
         ("S", ["IBM", 1.0, 1], 1002), ("S", ["IBM", 1.0, 1], 1003),
         ("S", ["WSO2", 1.0, 1], 1004)]
_P3_SPECS = [
    ("partition_by_key sample", "@app:playback\n" + _sample_text(
        "partition_by_key.siddhi"), "perSymbolMax",
     [("TradeStream", [["IBM", 10.5, 1], ["WSO2", 3.25, 2], ["IBM", 9.0, 3],
                       ["ORCL", 7.75, 4]], 1000),
      ("TradeStream", [["WSO2", 4.0, 5], ["IBM", 12.0, 6]], 1010),
      ("TradeStream", [["ORCL", 1.0, 7], ["WSO2", 2.0, 8]], 1020)]),
    ("count",
     """@app:playback
     define stream S (symbol string, price float, volume int);
     partition with (symbol of S)
     begin @info(name='query1')
       from S select symbol, count() as c insert into Out; end;""",
     "query1", _SYM3),
    ("group by under the partition key",
     """@app:playback
     define stream S (region string, symbol string, volume int);
     partition with (region of S)
     begin @info(name='query1')
       from S select region, symbol, sum(volume) as t
       group by symbol insert into Out; end;""", "query1",
     [("S", ["US", "IBM", 10], 1000), ("S", ["EU", "IBM", 100], 1001),
      ("S", ["US", "IBM", 1], 1002), ("S", ["US", "MSFT", 5], 1003),
      ("S", ["EU", "IBM", 2], 1004)]),
    ("inner stream chain",
     """@app:playback
     define stream S (symbol string, volume int);
     partition with (symbol of S)
     begin
       from S select symbol, count() as c insert into #Inner;
       @info(name='query2')
       from #Inner[c >= 2] select symbol, c insert into Out;
     end;""", "query2",
     [("S", ["A", 1], 1000), ("S", ["A", 1], 1001), ("S", ["B", 1], 1002),
      ("S", ["A", 1], 1003)]),
    ("length window per key",
     """@app:playback
     define stream S (sym string, price float);
     partition with (sym of S)
     begin @info(name='q') from S#window.length(2)
       select sym, sum(price) as total insert all events into Out; end;""",
     "q",
     [("S", ["A", 1.0], 1000), ("S", ["B", 10.0], 1001),
      ("S", ["A", 2.0], 1002), ("S", ["A", 4.0], 1003),
      ("S", ["B", 20.0], 1004)]),
    ("lengthBatch window per key",
     """@app:playback
     define stream S (sym string, v int);
     partition with (sym of S)
     begin @info(name='q') from S#window.lengthBatch(2)
       select sym, sum(v) as total insert into Out; end;""", "q",
     [("S", ["A", 1], 1000), ("S", ["B", 10], 1001), ("S", ["A", 2], 1002),
      ("S", ["B", 20], 1003), ("S", ["A", 5], 1004)]),
    ("partitioned join",
     """@app:playback
     define stream L (sym string, price float);
     define stream R (sym string, qty int);
     partition with (sym of L, sym of R)
     begin @info(name='j')
       from L#window.length(10) join R#window.length(10)
       select L.sym as s, L.price as p, R.qty as q insert into Out; end;""",
     "j",
     [("L", ["A", 10.0], 1000), ("L", ["B", 20.0], 1001),
      ("R", ["A", 7], 1002), ("R", ["C", 9], 1003), ("R", ["B", 3], 1004),
      ("L", ["A", 11.0], 1005)]),
    ("interleaved keys, length(3)", _KEYED.format(win="length(3)"), "q",
     _rows(1, 5, 12, 5)),
    ("interleaved keys, time(600), timer ticks",
     _KEYED.format(win="time(600)"), "q", _rows(2, 6, 12, 5)),
    ("interleaved keys, lengthBatch(2), several keys flush a send",
     _KEYED.format(win="lengthBatch(2)"), "q", _rows(3, 5, 12, 4)),
]
# PR 8's additions: range partitions, @purge, keyed timeBatch, a filter
# after a keyed window
_P3_SPECS += [
    ("range partition, one query",
     """@app:playback
     define stream S (sym string, price float, vol int);
     partition with (vol < 100 as 'small' or
                     vol >= 100 and vol < 1000 as 'medium' or
                     vol >= 1000 as 'large' of S)
     begin @info(name='q') from S select sym, sum(vol) as total
       insert into Out; end;""", "q",
     [("S", ["a", 1.0, 50], 1000), ("S", ["b", 1.0, 500], 1001),
      ("S", ["c", 1.0, 60], 1002), ("S", ["d", 1.0, 2000], 1003)]),
    ("range partition, unmatched rows leave",
     """@app:playback
     define stream S (sym string, vol int);
     partition with (vol < 10 as 'small' of S)
     begin @info(name='q') from S select sym, count() as n
       insert into Out; end;""", "q",
     [("S", ["in", 5], 1000), ("S", ["out", 50], 1001),
      ("S", ["in2", 7], 1002)]),
    ("range partition, pattern",
     """@app:playback
     define stream T (key long, price float, vol int);
     partition with (vol < 100 as 'small' or vol >= 100 as 'big' of T)
     begin @info(name='p')
       from every e1=T[price > 10.0] -> e2=T[price > e1.price]
       select e1.price as p1, e2.price as p2 insert into M; end;""", "p",
     [("T", [1, 20.0, 5], 1000), ("T", [2, 30.0, 500], 1001),
      ("T", [3, 25.0, 7], 1002), ("T", [4, 40.0, 600], 1003)]),
    ("purge recycles pattern slots",
     """@app:playback
     define stream T (key long, price float, vol int);
     partition with (key of T)
     begin
       @capacity(keys='16', slots='4')
       @purge(enable='true', interval='1 sec', idle.period='5 sec')
       @info(name='p')
       from every e1=T[vol == 1] -> e2=T[vol == 2 and price >= e1.price]
       select e1.key as k insert into M;
     end;""", "p",
     [("T", [[k, 5.0, 1] for k in range(16)], 1000),
      ("T", [[0, 5.0, 1]], 20_000),
      ("T", [[k, 5.0, 1] for k in range(100, 113)], 21_000),
      ("T", [[3, 9.0, 2]], 21_500),
      ("T", [[200, 5.0, 1], [200, 6.0, 2]], 22_000)]),
    ("range partition, lengthBatch per range",
     """@app:playback
     define stream S (sym string, vol int);
     partition with (vol < 100 as 'small' or vol >= 100 as 'big' of S)
     begin @info(name='q') from S#window.lengthBatch(2)
       select sym, sum(vol) as total insert into Out; end;""", "q",
     [("S", ["a", 1], 1000), ("S", ["b", 500], 1001), ("S", ["c", 2], 1002),
      ("S", ["d", 900], 1003)]),
    ("purge recycles group-by slots",
     """@app:playback
     define stream S (key long, v int);
     partition with (key of S)
     begin
       @purge(enable='true', interval='1 sec', idle.period='5 sec')
       @info(name='q') from S select key, sum(v) as total insert into Out;
     end;""", "q",
     [("S", [1, 10], 1000), ("S", [1, 5], 1100), ("S", [2, 1], 30_000),
      ("S", [1, 7], 31_000)]),
    ("interleaved keys, timeBatch(500)", _KEYED.format(win="timeBatch(500)"),
     "q", _rows(4, 8, 12, 5)),
    ("filter after a keyed window",
     """@app:playback
     define stream S (k long, v float, w int);
     partition with (k of S)
     begin
       @capacity(keys='64')
       @info(name='q') from S#window.length(3)[w > 2]
       select k, sum(v) as sv, count() as c insert all events into Out;
     end;""", "q", _rows(5, 6, 12, 5)),
]

_R1_BODIES = {
    "single-stream": (
        "define stream S (sym string, v int);\n",
        "from S[v > 0] select sym, v {rate} insert into Out;",
        [("S", [["a", 1]], 1000), ("S", [["b", 2]], 1300),
         ("S", [["a", 3]], 1600), ("S", [["c", 4]], 2100),
         ("S", [["b", 5]], 2200), ("S", [["a", -1]], 2300),
         ("S", [["a", 6]], 3500)]),
    "join": (
        "define stream L (sym string, p int);\n"
        "define stream R (sym string, q int);\n",
        "from L#window.length(4) join R#window.length(4) on L.sym == R.sym "
        "select L.sym as s, L.p as p, R.q as q {rate} insert into Out;",
        [("L", [["a", 1]], 1000), ("R", [["a", 10]], 1100),
         ("L", [["b", 2]], 1200), ("R", [["b", 20]], 1300),
         ("L", [["a", 3]], 1400), ("R", [["a", 30]], 2600),
         ("L", [["b", 4]], 2700)]),
    "pattern": (
        "define stream S (sym string, v int);\n",
        "from every e1=S[v == 1] -> e2=S[v > 1] select e1.sym as s, "
        "e2.v as v {rate} insert into Out;",
        [("S", [["a", 1]], 1000), ("S", [["a", 2]], 1100),
         ("S", [["b", 1]], 1200), ("S", [["b", 5]], 1300),
         ("S", [["a", 1]], 2400), ("S", [["a", 9]], 2500),
         ("S", [["c", 1]], 2600), ("S", [["c", 2]], 3700)]),
    "partitioned": (
        "define stream S (sym string, v int);\n",
        "partition with (sym of S) begin @info(name='q') "
        "from S#window.length(2) select sym, sum(v) as t "
        "{rate} insert into Out; end;",
        [("S", [["a", 1]], 1000), ("S", [["b", 2]], 1100),
         ("S", [["a", 3]], 1200), ("S", [["b", 4]], 1300),
         ("S", [["a", 5]], 2400), ("S", [["c", 6]], 2500),
         ("S", [["b", 7]], 3600)]),
}
_R1_RATES = ["output all every 2 events", "output first every 2 events",
             "output last every 2 events", "output all every 1 sec",
             "output first every 1 sec", "output last every 1 sec",
             "output snapshot every 1 sec"]


def _r1_specs():
    out = []
    for kind, (defs, body, sends) in _R1_BODIES.items():
        for rate in _R1_RATES:
            q = body.format(rate=rate)
            if not q.startswith("partition"):
                q = "@info(name='q') " + q
            out.append((f"{kind}: {rate}", "@app:playback\n" + defs + q,
                        "q", sends))
    return out


_R1_SPECS = _r1_specs()

# the events the JAX package gives for P3 and R1 (held to it by
# tests/test_torch_partition.py and tests/test_torch_ratelimit.py)
_P3_WANT = [[(1000,
   [(1000, ('IBM', 10.5)), (1000, ('WSO2', 3.25)), (1000, ('IBM', 10.5)),
    (1000, ('ORCL', 7.75))],
   []),
  (1010, [(1010, ('WSO2', 4.0)), (1010, ('IBM', 12.0))], []),
  (1020, [(1020, ('ORCL', 7.75)), (1020, ('WSO2', 4.0))], [])],
 [(1000, [(1000, ('IBM', 1))], []), (1001, [(1001, ('WSO2', 1))], []),
  (1002, [(1002, ('IBM', 2))], []), (1003, [(1003, ('IBM', 3))], []),
  (1004, [(1004, ('WSO2', 2))], [])],
 [(1000, [(1000, ('US', 'IBM', 10))], []),
  (1001, [(1001, ('EU', 'IBM', 100))], []),
  (1002, [(1002, ('US', 'IBM', 11))], []),
  (1003, [(1003, ('US', 'MSFT', 5))], []),
  (1004, [(1004, ('EU', 'IBM', 102))], [])],
 [(1001, [(1001, ('A', 2))], []), (1003, [(1003, ('A', 3))], [])],
 [(1000, [(1000, ('A', 1.0))], []), (1001, [(1001, ('B', 10.0))], []),
  (1002, [(1002, ('A', 3.0))], []),
  (1003, [(1003, ('A', 6.0))], [(1000, ('A', 2.0))]),
  (1004, [(1004, ('B', 30.0))], [])],
 [(1002, [(1000, ('A', 1)), (1002, ('A', 3))], []),
  (1003, [(1001, ('B', 10)), (1003, ('B', 30))], [])],
 [(1002, [(1002, ('A', 10.0, 7))], []),
  (1004, [(1004, ('B', 20.0, 3))], []),
  (1005, [(1005, ('A', 11.0, 7))], [])],
 [(1000,
   [(1000, (1, 0.125, 1, 3)), (1000, (1, 0.328125, 2, 4)),
    (1000, (0, 0.984375, 1, 6)), (1000, (0, 1.875, 2, 6)),
    (1000, (3, 0.75, 1, 2)), (1000, (3, 1.609375, 2, 8)),
    (1000, (3, 2.0625, 3, 8)), (1000, (4, 0.015625, 1, 5)),
    (1000, (4, 0.453125, 2, 6))],
   []),
  (1250,
   [(1250, (1, 0.765625, 3, 6)), (1250, (1, 1.234375, 3, 6)),
    (1250, (1, 1.828125, 3, 6)), (1250, (1, 2.109375, 3, 7)),
    (1250, (3, 1.375, 3, 8)), (1250, (4, 0.640625, 3, 6)),
    (1250, (4, 1.46875, 3, 7)), (1250, (4, 2.015625, 3, 7)),
    (1250, (4, 2.03125, 3, 7)), (1250, (2, 0.03125, 1, 5)),
    (1250, (2, 0.265625, 2, 5)), (1250, (2, 0.4375, 3, 6))],
   [(1000, (1, 0.640625, 2, 6)), (1000, (1, 1.03125, 2, 6)),
    (1250, (1, 1.390625, 2, 6)), (1000, (3, 1.3125, 2, 8)),
    (1000, (4, 0.625, 2, 6)), (1000, (4, 1.03125, 2, 7)),
    (1250, (4, 1.828125, 2, 7))]),
  (1500,
   [(1500, (1, 1.96875, 3, 7)), (1500, (0, 2.484375, 3, 8)),
    (1500, (0, 2.453125, 3, 8)), (1500, (3, 0.5625, 3, 8)),
    (1500, (4, 1.96875, 3, 7)), (1500, (4, 1.765625, 3, 7)),
    (1500, (4, 2.25, 3, 8)), (1500, (4, 1.46875, 3, 8)),
    (1500, (4, 0.9375, 3, 8)), (1500, (4, 0.65625, 3, 8)),
    (1500, (2, 1.3125, 3, 6))],
   [(1250, (1, 1.515625, 2, 7)), (1000, (0, 1.5, 2, 8)),
    (1000, (3, 0.515625, 2, 8)), (1250, (4, 1.1875, 2, 7)),
    (1250, (4, 0.984375, 2, 7)), (1250, (4, 1.5625, 2, 7)),
    (1500, (4, 1.46875, 2, 8)), (1500, (4, 0.6875, 2, 8)),
    (1500, (4, 0.25, 2, 8)), (1250, (2, 0.40625, 2, 6))]),
  (1750,
   [(1750, (1, 1.53125, 3, 7)), (1750, (1, 1.34375, 3, 7)),
    (1750, (3, 1.078125, 3, 8)), (1750, (3, 1.03125, 3, 8)),
    (1750, (4, 1.046875, 3, 8)), (1750, (4, 1.453125, 3, 8)),
    (1750, (4, 1.09375, 3, 8)), (1750, (4, 1.0625, 3, 8)),
    (1750, (2, 1.203125, 3, 6))],
   [(1250, (1, 1.171875, 2, 7)), (1250, (1, 0.8125, 2, 7)),
    (1000, (3, 0.109375, 2, 8)), (1250, (3, 1.015625, 2, 8)),
    (1500, (4, 0.65625, 2, 8)), (1500, (4, 0.796875, 2, 8)),
    (1500, (4, 1.046875, 2, 8)), (1750, (4, 0.703125, 2, 8)),
    (1250, (2, 1.078125, 2, 6))]),
  (2000,
   [(2000, (1, 1.390625, 3, 7)), (2000, (1, 1.5625, 3, 7)),
    (2000, (1, 1.0625, 3, 7)), (2000, (1, 0.625, 3, 7)),
    (2000, (1, 0.984375, 3, 7)), (2000, (0, 2.0625, 3, 8)),
    (2000, (3, 1.625, 3, 8)), (2000, (3, 1.03125, 3, 8)),
    (2000, (3, 1.859375, 3, 8)), (2000, (2, 1.796875, 3, 6))],
   [(1500, (1, 0.890625, 2, 7)), (1750, (1, 1.03125, 2, 7)),
    (1750, (1, 1.03125, 2, 7)), (2000, (1, 0.5625, 2, 7)),
    (2000, (1, 0.09375, 2, 7)), (1000, (0, 1.5625, 2, 8)),
    (1500, (3, 0.984375, 2, 8)), (1750, (3, 0.65625, 2, 8)),
    (1750, (3, 1.015625, 2, 8)), (1250, (2, 1.03125, 2, 6))])],
 [(1000,
   [(1000, (0, 0.171875, 1, 0)), (1000, (0, 0.484375, 2, 5)),
    (1000, (0, 1.203125, 3, 6)), (1000, (0, 1.546875, 4, 6)),
    (1000, (2, 0.328125, 1, 3)), (1000, (2, 0.75, 2, 8)),
    (1000, (2, 1.5, 3, 8)), (1000, (3, 0.734375, 1, 7)),
    (1000, (4, 0.328125, 1, 7)), (1000, (1, 0.46875, 1, 2)),
    (1000, (1, 0.734375, 2, 7))],
   []),
  (1250,
   [(1250, (2, 2.21875, 4, 8)), (1250, (2, 3.203125, 5, 8)),
    (1250, (3, 1.453125, 2, 8)), (1250, (3, 2.140625, 3, 8)),
    (1250, (4, 1.046875, 2, 7)), (1250, (4, 1.40625, 3, 7)),
    (1250, (4, 1.890625, 4, 7)), (1250, (4, 2.59375, 5, 7)),
    (1250, (4, 3.5, 6, 7)), (1250, (4, 4.03125, 7, 7)),
    (1250, (1, 1.53125, 3, 7)), (1250, (1, 2.171875, 4, 7))],
   []),
  (1500,
   [(1500, (0, 1.921875, 5, 6)), (1500, (0, 2.015625, 6, 6)),
    (1500, (2, 3.796875, 6, 8)), (1500, (2, 3.9375, 7, 8)),
    (1500, (2, 4.65625, 8, 8)), (1500, (4, 4.84375, 8, 7)),
    (1500, (4, 5.296875, 9, 7)), (1500, (4, 5.5625, 10, 7)),
    (1500, (1, 3.140625, 5, 7)), (1500, (1, 3.1875, 6, 7))],
   []),
  (1600, [],
   [(1600, (0, 1.84375, 5, 6)), (1600, (0, 1.53125, 4, 6)),
    (1600, (0, 0.8125, 3, 6)), (1600, (0, 0.46875, 2, 6)),
    (1600, (2, 4.328125, 7, 8)), (1600, (2, 3.90625, 6, 8)),
    (1600, (2, 3.15625, 5, 8)), (1600, (3, 1.40625, 2, 8)),
    (1600, (4, 5.234375, 9, 7)), (1600, (1, 2.71875, 5, 7)),
    (1600, (1, 2.453125, 4, 7))]),
  (1750,
   [(1750, (0, 0.5, 3, 6)), (1750, (2, 3.40625, 6, 8)),
    (1750, (2, 3.625, 7, 8)), (1750, (2, 4.515625, 8, 8)),
    (1750, (3, 1.703125, 3, 8)), (1750, (4, 5.3125, 10, 7)),
    (1750, (4, 5.390625, 11, 7)), (1750, (1, 2.453125, 5, 7)),
    (1750, (1, 2.625, 6, 7))],
   []),
  (1850, [],
   [(1850, (2, 3.796875, 7, 8)), (1850, (2, 2.8125, 6, 8)),
    (1850, (3, 0.984375, 2, 8)), (1850, (3, 0.296875, 1, 8)),
    (1850, (4, 4.671875, 10, 7)), (1850, (4, 4.3125, 9, 7)),
    (1850, (4, 3.828125, 8, 7)), (1850, (4, 3.125, 7, 7)),
    (1850, (4, 2.21875, 6, 7)), (1850, (4, 1.6875, 5, 7)),
    (1850, (1, 1.828125, 5, 7)), (1850, (1, 1.1875, 4, 7))]),
  (2000,
   [(2000, (0, 0.546875, 4, 6)), (2000, (0, 1.03125, 5, 6)),
    (2000, (0, 1.484375, 6, 8)), (2000, (2, 3.328125, 7, 8)),
    (2000, (2, 3.390625, 8, 8)), (2000, (3, 0.75, 2, 8)),
    (2000, (3, 0.890625, 3, 8)), (2000, (4, 2.328125, 6, 7)),
    (2000, (1, 1.96875, 5, 7)), (2000, (1, 2.296875, 6, 7))],
   []),
  (2100, [],
   [(2100, (0, 1.109375, 5, 8)), (2100, (0, 1.015625, 4, 8)),
    (2100, (2, 2.796875, 7, 8)), (2100, (2, 2.65625, 6, 8)),
    (2100, (2, 1.9375, 5, 8)), (2100, (4, 1.515625, 5, 7)),
    (2100, (4, 1.0625, 4, 7)), (2100, (4, 0.796875, 3, 7)),
    (2100, (1, 1.328125, 5, 7)), (2100, (1, 1.28125, 4, 7))]),
  (2250,
   [(2250, (0, 1.1875, 5, 8)), (2250, (3, 1.4375, 4, 8)),
    (2250, (3, 2.25, 5, 8)), (2250, (3, 3.15625, 6, 8)),
    (2250, (4, 1.515625, 4, 7)), (2250, (4, 2.265625, 5, 7)),
    (2250, (4, 2.296875, 6, 8)), (2250, (1, 1.734375, 5, 7)),
    (2250, (1, 1.78125, 6, 7)), (2250, (1, 2.640625, 7, 7))],
   [])],
 [(1000,
   [(1000, (1, 0.25, 1, 4)), (1000, (1, 0.625, 2, 6)),
    (1000, (1, 0.296875, 1, 7)), (1000, (1, 0.375, 2, 7)),
    (1000, (3, 0.125, 1, 8)), (1000, (3, 0.90625, 2, 8)),
    (1000, (3, 0.015625, 1, 0)), (1000, (3, 0.859375, 2, 5)),
    (1000, (0, 0.9375, 1, 3)), (1000, (0, 1.46875, 2, 6))],
   [(1000, (1, 0.375, 1, 6)), (1000, (1, None, 0, 6)),
    (1000, (3, 0.78125, 1, 8)), (1000, (3, None, 0, 8))]),
  (1250,
   [(1000, (3, 0.265625, 1, 4)), (1250, (3, 0.6875, 2, 4)),
    (1250, (3, 0.59375, 1, 5)), (1250, (3, 1.28125, 2, 7)),
    (1000, (0, 0.0625, 1, 1)), (1250, (0, 0.609375, 2, 8)),
    (1250, (0, 0.421875, 1, 8)), (1250, (0, 1.375, 2, 8)),
    (1250, (2, 0.5625, 1, 0)), (1250, (2, 1.40625, 2, 5))],
   [(1000, (3, -0.015625, -1, None)), (1000, (3, -0.859375, -2, None)),
    (1000, (3, 0.421875, 1, 4)), (1250, (3, None, 0, 4)),
    (1000, (0, -0.9375, -1, None)), (1000, (0, -1.46875, -2, None)),
    (1000, (0, 0.546875, 1, 8)), (1250, (0, None, 0, 8))]),
  (1500,
   [(1250, (1, 0.640625, 1, 7)), (1500, (1, 0.703125, 2, 7)),
    (1250, (3, 0.453125, 1, 4)), (1500, (3, 1.359375, 2, 7)),
    (1250, (0, 0.6875, 1, 0)), (1500, (0, 0.765625, 2, 8)),
    (1500, (0, 0.75, 1, 8)), (1500, (0, 0.890625, 2, 8)),
    (1500, (0, 0.390625, 1, 5)), (1500, (0, 1.0625, 2, 5)),
    (1500, (2, 0.546875, 1, 7)), (1500, (2, 1.0625, 2, 7)),
    (1500, (2, 0.265625, 1, 5)), (1500, (2, 1.125, 2, 5))],
   [(1000, (1, -0.296875, -1, None)), (1000, (1, -0.375, -2, None)),
    (1250, (3, -0.59375, -1, None)), (1250, (3, -1.28125, -2, None)),
    (1250, (0, -0.421875, -1, None)), (1250, (0, -1.375, -2, None)),
    (1250, (0, 0.078125, 1, 8)), (1500, (0, None, 0, 8)),
    (1500, (0, 0.140625, 1, 8)), (1500, (0, None, 0, 8)),
    (1250, (2, -0.5625, -1, None)), (1250, (2, -1.40625, -2, None)),
    (1500, (2, 0.515625, 1, 7)), (1500, (2, None, 0, 7))]),
  (1750,
   [(1750, (2, 0.859375, 1, 3)), (1750, (2, 1.78125, 2, 4)),
    (1750, (2, 0.546875, 1, 6)), (1750, (2, 1.046875, 2, 6)),
    (1750, (2, 0.625, 1, 1)), (1750, (2, 0.984375, 2, 4))],
   [(1500, (2, 0.859375, 1, 5)), (1500, (2, None, 0, 5)),
    (1750, (2, 0.921875, 1, 4)), (1750, (2, None, 0, 4)),
    (1750, (2, 0.5, 1, 6)), (1750, (2, None, 0, 6))]),
  (2000,
   [(2000, (1, 0.609375, 1, 7)), (2000, (1, 1.140625, 2, 7)),
    (2000, (1, 0.625, 1, 8)), (2000, (1, 1.171875, 2, 8)),
    (1500, (3, 0.203125, 1, 8)), (2000, (3, 0.53125, 2, 8)),
    (2000, (0, 0.203125, 1, 8)), (2000, (0, 0.265625, 2, 8)),
    (1750, (2, 0.515625, 1, 3)), (2000, (2, 0.875, 2, 5)),
    (2000, (2, 0.65625, 1, 2)), (2000, (2, 1.078125, 2, 8))],
   [(1250, (1, -0.640625, -1, None)), (1500, (1, -0.703125, -2, None)),
    (2000, (1, 0.53125, 1, 7)), (2000, (1, None, 0, 7)),
    (1250, (3, -0.453125, -1, None)), (1500, (3, -1.359375, -2, None)),
    (1500, (0, -0.390625, -1, None)), (1500, (0, -1.0625, -2, None)),
    (1750, (2, -0.625, -1, None)), (1750, (2, -0.984375, -2, None)),
    (1750, (2, 0.359375, 1, 5)), (2000, (2, None, 0, 5))])]]
_R1_WANT = [[(1300, [(1000, ('a', 1)), (1300, ('b', 2))], []),
  (2100, [(1600, ('a', 3)), (2100, ('c', 4))], []),
  (3500, [(2200, ('b', 5)), (3500, ('a', 6))], [])],
 [(1000, [(1000, ('a', 1))], []), (1600, [(1600, ('a', 3))], []),
  (2200, [(2200, ('b', 5))], [])],
 [(1300, [(1300, ('b', 2))], []), (2100, [(2100, ('c', 4))], []),
  (3500, [(3500, ('a', 6))], [])],
 [(2000, [(1000, ('a', 1)), (1300, ('b', 2)), (1600, ('a', 3))], []),
  (3000, [(2100, ('c', 4)), (2200, ('b', 5))], [])],
 [(1000, [(1000, ('a', 1))], []), (2100, [(2100, ('c', 4))], []),
  (3500, [(3500, ('a', 6))], [])],
 [(2000, [(1600, ('a', 3))], []), (3000, [(2200, ('b', 5))], [])],
 [(2000, [(1600, ('a', 3))], []), (3000, [(2200, ('b', 5))], [])],
 [(1300, [(1100, ('a', 1, 10)), (1300, ('b', 2, 20))], []),
  (2600, [(1400, ('a', 3, 10)), (2600, ('a', 1, 30))], []),
  (2700, [(2600, ('a', 3, 30)), (2700, ('b', 4, 20))], [])],
 [(1100, [(1100, ('a', 1, 10))], []), (1400, [(1400, ('a', 3, 10))], []),
  (2600, [(2600, ('a', 3, 30))], [])],
 [(1300, [(1300, ('b', 2, 20))], []), (2600, [(2600, ('a', 1, 30))], []),
  (2700, [(2700, ('b', 4, 20))], [])],
 [(2000, [(1100, ('a', 1, 10)), (1300, ('b', 2, 20)), (1400, ('a', 3, 10))],
   [])],
 [(1100, [(1100, ('a', 1, 10))], []), (2600, [(2600, ('a', 1, 30))], [])],
 [(2000, [(1400, ('a', 3, 10))], [])], [(2000, [(1400, ('a', 3, 10))], [])],
 [(1300, [(1100, ('a', 2)), (1300, ('b', 5))], []),
  (3700, [(2500, ('a', 9)), (3700, ('c', 2))], [])],
 [(1100, [(1100, ('a', 2))], []), (2500, [(2500, ('a', 9))], [])],
 [(1300, [(1300, ('b', 5))], []), (3700, [(3700, ('c', 2))], [])],
 [(2000, [(1100, ('a', 2)), (1300, ('b', 5))], []),
  (3000, [(2500, ('a', 9))], [])],
 [(1100, [(1100, ('a', 2))], []), (2500, [(2500, ('a', 9))], []),
  (3700, [(3700, ('c', 2))], [])],
 [(2000, [(1300, ('b', 5))], []), (3000, [(2500, ('a', 9))], [])],
 [(2000, [(1300, ('b', 5))], []), (3000, [(2500, ('a', 9))], [])],
 [(1100, [(1000, ('a', 1)), (1100, ('b', 2))], []),
  (1300, [(1200, ('a', 4)), (1300, ('b', 6))], []),
  (2400, [(2400, ('a', 8))], [(1000, ('a', 3))]),
  (3600, [(2500, ('c', 6))], [(1100, ('b', 4))])],
 [(1000, [(1000, ('a', 1))], []), (1200, [(1200, ('a', 4))], []),
  (2400, [], [(1000, ('a', 3))]), (2500, [(2500, ('c', 6))], []),
  (3600, [(3600, ('b', 11))], [])],
 [(1100, [(1100, ('b', 2))], []), (1300, [(1300, ('b', 6))], []),
  (2400, [(2400, ('a', 8))], []), (3600, [], [(1100, ('b', 4))])],
 [(2000,
   [(1000, ('a', 1)), (1100, ('b', 2)), (1200, ('a', 4)), (1300, ('b', 6))],
   []),
  (3000, [(2400, ('a', 8)), (2500, ('c', 6))], [(1000, ('a', 3))])],
 [(1000, [(1000, ('a', 1))], []), (2400, [], [(1000, ('a', 3))]),
  (3600, [], [(1100, ('b', 4))])],
 [(2000, [(1300, ('b', 6))], []), (3000, [(2500, ('c', 6))], [])],
 [(2000, [(1300, ('b', 6))], []), (3000, [(2500, ('c', 6))], [])]]
_P3_WANT += [[(1000, [(1000, ('a', 50))], []),
  (1001, [(1001, ('b', 500))], []),
  (1002, [(1002, ('c', 110))], []),
  (1003, [(1003, ('d', 2000))], [])],
 [(1000, [(1000, ('in', 1))], []), (1002, [(1002, ('in2', 2))], [])],
 [(1002, [(1002, (20.0, 25.0))], []), (1003, [(1003, (30.0, 40.0))], [])],
 [(22000, [(22000, (200,))], [])],
 [(1002, [(1000, ('a', 1)), (1002, ('c', 3))], []),
  (1003, [(1001, ('b', 500)), (1003, ('d', 1400))], [])],
 [(1000, [(1000, (1, 10))], []),
  (1100, [(1100, (1, 15))], []),
  (30000, [(30000, (2, 1))], []),
  (31000, [(31000, (1, 7))], [])],
 [(1500,
   [(1000, (1, 0.59375, 1, 0)),
    (1000, (1, 1.3125, 2, 3)),
    (1000, (1, 1.515625, 3, 3)),
    (1000, (1, 1.5625, 4, 3)),
    (1000, (1, 2.5, 5, 3)),
    (1250, (1, 3.3125, 6, 5)),
    (1250, (1, 3.703125, 7, 5)),
    (1000, (3, 0.953125, 1, 1)),
    (1250, (3, 1.265625, 2, 2)),
    (1250, (3, 1.65625, 3, 6)),
    (1250, (3, 2.296875, 4, 7)),
    (1000, (0, 0.671875, 1, 5)),
    (1250, (0, 0.75, 2, 6)),
    (1000, (2, 0.375, 1, 1)),
    (1000, (2, 0.953125, 2, 4)),
    (1250, (2, 1.5625, 3, 7)),
    (1250, (2, 2.5, 4, 7)),
    (1250, (2, 2.859375, 5, 7)),
    (1000, (4, 0.484375, 1, 1)),
    (1250, (4, 1.046875, 2, 5))],
   []),
  (2000,
   [(1500, (1, 0.640625, 1, 0)),
    (1750, (1, 1.484375, 2, 2)),
    (1750, (1, 1.5625, 3, 7)),
    (1500, (3, 0.140625, 1, 3)),
    (1500, (3, 0.453125, 2, 4)),
    (1750, (3, 0.9375, 3, 4)),
    (1750, (3, 1.328125, 4, 4)),
    (1500, (0, 0.453125, 1, 3)),
    (1750, (0, 1.359375, 2, 3)),
    (1750, (0, 1.6875, 3, 8)),
    (1750, (0, 1.921875, 4, 8)),
    (1500, (2, 0.34375, 1, 3)),
    (1500, (2, 0.5, 2, 3)),
    (1500, (2, 0.53125, 3, 4)),
    (1500, (2, 1.171875, 4, 4)),
    (1500, (2, 1.4375, 5, 4)),
    (1750, (2, 2.15625, 6, 4)),
    (1750, (2, 2.96875, 7, 4)),
    (1500, (4, 0.46875, 1, 0)),
    (1500, (4, 0.84375, 2, 6)),
    (1750, (4, 0.859375, 3, 6)),
    (1750, (4, 1.046875, 4, 6))],
   [(1000, (1, -0.59375, -1, None)),
    (1000, (1, -1.3125, -2, None)),
    (1000, (1, -1.515625, -3, None)),
    (1000, (1, -1.5625, -4, None)),
    (1000, (1, -2.5, -5, None)),
    (1250, (1, -3.3125, -6, None)),
    (1250, (1, -3.703125, -7, None)),
    (1000, (3, -0.953125, -1, None)),
    (1250, (3, -1.265625, -2, None)),
    (1250, (3, -1.65625, -3, None)),
    (1250, (3, -2.296875, -4, None)),
    (1000, (0, -0.671875, -1, None)),
    (1250, (0, -0.75, -2, None)),
    (1000, (2, -0.375, -1, None)),
    (1000, (2, -0.953125, -2, None)),
    (1250, (2, -1.5625, -3, None)),
    (1250, (2, -2.5, -4, None)),
    (1250, (2, -2.859375, -5, None)),
    (1000, (4, -0.484375, -1, None)),
    (1250, (4, -1.046875, -2, None))]),
  (2500,
   [(2000, (1, 0.984375, 1, 2)),
    (2000, (1, 1.4375, 2, 5)),
    (2250, (1, 2.109375, 3, 5)),
    (2250, (1, 3.03125, 4, 8)),
    (2250, (1, 3.03125, 5, 8)),
    (2250, (1, 3.046875, 6, 8)),
    (2000, (3, 0.8125, 1, 6)),
    (2000, (3, 1.296875, 2, 6)),
    (2000, (3, 2.0625, 3, 6)),
    (2000, (3, 2.46875, 4, 8)),
    (2250, (3, 3.09375, 5, 8)),
    (2250, (3, 3.890625, 6, 8)),
    (2000, (0, 0.4375, 1, 5)),
    (2000, (0, 0.5, 2, 5)),
    (2000, (0, 1.125, 3, 8)),
    (2250, (0, 1.671875, 4, 8)),
    (2250, (0, 2.453125, 5, 8)),
    (2000, (2, 0.484375, 1, 7)),
    (2000, (2, 0.765625, 2, 7)),
    (2250, (2, 1.546875, 3, 7)),
    (2250, (2, 1.765625, 4, 7)),
    (2250, (4, 0.421875, 1, 3))],
   [(1500, (1, -0.640625, -1, None)),
    (1750, (1, -1.484375, -2, None)),
    (1750, (1, -1.5625, -3, None)),
    (1500, (3, -0.140625, -1, None)),
    (1500, (3, -0.453125, -2, None)),
    (1750, (3, -0.9375, -3, None)),
    (1750, (3, -1.328125, -4, None)),
    (1500, (0, -0.453125, -1, None)),
    (1750, (0, -1.359375, -2, None)),
    (1750, (0, -1.6875, -3, None)),
    (1750, (0, -1.921875, -4, None)),
    (1500, (2, -0.34375, -1, None)),
    (1500, (2, -0.5, -2, None)),
    (1500, (2, -0.53125, -3, None)),
    (1500, (2, -1.171875, -4, None)),
    (1500, (2, -1.4375, -5, None)),
    (1750, (2, -2.15625, -6, None)),
    (1750, (2, -2.96875, -7, None)),
    (1500, (4, -0.46875, -1, None)),
    (1500, (4, -0.84375, -2, None)),
    (1750, (4, -0.859375, -3, None)),
    (1750, (4, -1.046875, -4, None))])],
 [(1000,
   [(1000, (4, 0.5, 1)),
    (1000, (4, 0.546875, 2)),
    (1000, (1, 0.75, 1)),
    (1000, (1, 1.5625, 2)),
    (1000, (0, 0.734375, 1)),
    (1000, (0, 1.0, 2))],
   [(1000, (1, 0.8125, 1)), (1000, (1, None, 0))]),
  (1250,
   [(1250, (4, 0.046875, 2)),
    (1250, (1, 0.578125, 1)),
    (1250, (1, 1.34375, 2)),
    (1250, (1, 1.046875, 2)),
    (1250, (0, 0.984375, 2)),
    (1250, (0, 1.640625, 3)),
    (1250, (2, 0.125, 1)),
    (1250, (2, 0.734375, 2)),
    (1250, (2, 1.09375, 3)),
    (1250, (2, 1.0, 3))],
   [(1000, (4, 0.046875, 1)),
    (1250, (1, 0.765625, 1)),
    (1000, (0, 0.265625, 1)),
    (1250, (2, 0.96875, 2))]),
  (1500,
   [(1500, (4, 0.015625, 2)),
    (1500, (1, 0.953125, 2)),
    (1500, (0, 1.734375, 3)),
    (1500, (0, 1.75, 3)),
    (1500, (2, 0.890625, 3)),
    (1500, (2, 1.078125, 3)),
    (1500, (3, 0.03125, 1)),
    (1500, (3, 0.75, 2)),
    (1500, (3, 1.4375, 3))],
   [(1000, (4, 0.0, 1)),
    (1250, (1, 0.28125, 1)),
    (1000, (0, 1.375, 2)),
    (1250, (0, 1.015625, 2)),
    (1250, (0, 1.09375, 2)),
    (1250, (2, 0.390625, 2)),
    (1250, (2, 0.53125, 2))]),
  (1750,
   [(1750, (4, 0.25, 1)),
    (1750, (1, 1.28125, 2)),
    (1750, (1, 1.296875, 2)),
    (1750, (0, 1.34375, 2)),
    (1750, (0, 0.671875, 2)),
    (1750, (0, 1.0, 3))],
   [(1250, (4, 0.015625, 1)),
    (1500, (4, None, 0)),
    (1250, (1, 0.671875, 1)),
    (1500, (1, 0.609375, 1)),
    (1500, (0, 0.734375, 1)),
    (1500, (0, 0.609375, 1)),
    (1250, (2, 1.046875, 2)),
    (1500, (2, 0.546875, 1)),
    (1500, (2, None, 0)),
    (1500, (3, 1.40625, 2))]),
  (2000,
   [(2000, (1, 1.671875, 2)),
    (2000, (1, 1.84375, 3)),
    (2000, (0, 1.140625, 3)),
    (2000, (2, 0.0625, 1)),
    (2000, (2, 0.609375, 2)),
    (2000, (2, 1.1875, 3)),
    (2000, (3, 0.328125, 1)),
    (2000, (3, 1.296875, 2)),
    (2000, (3, 1.84375, 3))],
   [(1750, (1, 0.6875, 1)),
    (1750, (0, 0.390625, 2)),
    (1500, (3, 0.6875, 1)),
    (1500, (3, None, 0)),
    (2000, (3, 1.515625, 2))]),
  (2250,
   [(2250, (4, 0.75, 2)),
    (2250, (4, 1.453125, 3)),
    (2250, (4, 2.03125, 3)),
    (2250, (1, 1.171875, 3)),
    (2250, (2, 2.046875, 3)),
    (2250, (2, 2.1875, 3)),
    (2250, (2, 1.953125, 3)),
    (2250, (2, 1.6875, 3)),
    (2250, (2, 1.953125, 3))],
   [(1750, (4, 1.203125, 2)),
    (2250, (4, 1.53125, 2)),
    (1750, (1, 1.15625, 2)),
    (2000, (1, 0.1875, 2)),
    (1750, (0, 1.078125, 2)),
    (2000, (2, 1.125, 2)),
    (2000, (2, 1.5, 2)),
    (2000, (2, 1.609375, 2)),
    (2250, (2, 1.03125, 2)),
    (2250, (2, 1.0, 2))])]]

P3_CASES = [spec + (want,) for spec, want in zip(_P3_SPECS, _P3_WANT)]
R1_CASES = [spec + (want,) for spec, want in zip(_R1_SPECS, _R1_WANT)]

# ---------------------------------------------------------------------------
# phases 25-28: `in Table` (K14 in_probe and the bytecode's IN inside K1,
# K11, pattern_step and K8), timeBatch (K12 time_batch), order by / limit /
# offset (K13 order_limit), join group by (K4 over composed slots)
# ---------------------------------------------------------------------------

W1_KEYS = 4000            # W1's devices: 4,000 (room, device) groups
W1_B = 1 << 17            # W1's readings a send
W1_DT = 75_000            # event time a send: 8 sends a 10-minute slice
W1_FILL, W1_TIMED, W1_CHECK = 8, 32, 8
IN1_FILL, IN1_TIMED = 8, 16
WATCH_ROWS = 1 << 16      # the Watch table of the OP_IN comparisons
J1G_TIMED = 16


def slice7_modules():
    from siddhi_tpu_torch.kernels import (filter_compact, group_agg,
                                          in_probe, order_limit, table_match,
                                          table_write, time_batch)
    return {"in_probe": in_probe, "filter_compact": filter_compact,
            "time_batch": time_batch, "group_agg": group_agg,
            "order_limit": order_limit, "table_match": table_match,
            "table_write": table_write}


class ProbeTable:
    """A table's first column and valid flags as K14 sees them (the
    TableRuntime attributes its wrapper reads)."""

    def __init__(self, col, valid):
        self.cols, self.valid = (col,), valid
        self.version, self.in_sets = 0, {}


def probe_cases(torch, np, dev):
    """(label, column, valid, operand): IN1's shape, then the edge values:
    int nulls and a LONG operand over an INT column, -0.0 / +0.0 and NaN,
    a float operand over an INT column, bools, the hash set's own EMPTY
    key, an all-invalid table."""
    rng = np.random.default_rng(71)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    C = T1_ROWS
    out = [("IN1 LONG ids", t(rng.permutation(C).astype(np.int64)),
            t(rng.random(C) < 0.97),
            t(rng.integers(0, C + T1_MISS, T1_B).astype(np.int64)))]
    icol = rng.integers(-50, 50, 4096).astype(np.int32)
    icol[::7] = np.iinfo(np.int32).min
    iops = rng.integers(-60, 60, 65536).astype(np.int64)
    iops[::11] = np.iinfo(np.int32).min
    iops[::13] = np.iinfo(np.int64).min
    iops[::17] = 2 ** 31 + 3
    out.append(("INT column, LONG operand, nulls", t(icol),
                t(rng.random(4096) < 0.8), t(iops)))
    fvals = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 3.0],
                     np.float32)
    out.append(("FLOAT column with -0.0 / NaN", t(rng.choice(fvals, 2048)),
                t(rng.random(2048) < 0.9), t(rng.choice(fvals, 65536))))
    out.append(("INT column, FLOAT operand", t(icol), t(np.ones(4096, bool)),
                t(rng.choice(np.array([3.0, 3.5, -4.0, np.nan], np.float32),
                             65536))))
    out.append(("BOOL", t(rng.random(64) < 0.5), t(rng.random(64) < 0.5),
                t(rng.random(65536) < 0.5)))
    empty_key = np.array([0xa5a5a5a5a5a5a5a5], np.uint64).view(np.int64)
    ecol = np.concatenate([empty_key, rng.integers(0, 99, 1023)])
    eops = rng.integers(0, 120, 65536).astype(np.int64)
    eops[::5] = empty_key[0]
    out.append(("the set's EMPTY key as a value", t(ecol),
                t(np.ones(1024, bool)), t(eops)))
    out.append(("all rows invalid", t(icol), t(np.zeros(4096, bool)),
                t(iops)))
    return out


def compare_in_probe(torch, np, dev):
    """Phase 25a: K14 (build + lookup) against its plain version on every
    probe case; its time at IN1's shape beside the plain dense compare and
    torch.isin.  Returns (err, timing)."""
    from siddhi_tpu_torch.kernels import in_probe as ip
    err = 0.0
    timing = None
    for label, col, valid, vals in probe_cases(torch, np, dev):
        tab = ip.InTab(ProbeTable(col, valid))
        got = ip.lookup(vals, tab)
        want = ip.plain(vals, col, valid)
        torch.cuda.synchronize()
        err = max(err, float_err(torch, got, want, f"K14 {label}"))
        print(f"compare: K14 {label}: lookup == plain over {vals.shape[0]} "
              f"probes of {col.shape[0]} rows ({int(want.sum())} found)")
        if timing is None:
            timing = (tab, vals)
    tab, vals = timing
    ct = ip.compare_code(vals.dtype, tab.col0.dtype)

    def build():
        tab.table.version += 1
        ip.device_set(tab, ct)
    b_ms = graph_ms(torch, build, 20)
    l_ms = graph_ms(torch, lambda: ip.lookup(vals, tab), 20)
    plain_ms = event_timer(torch, lambda: ip.plain(vals, tab.col0,
                                                   tab.valid), 2)
    live = tab.col0[tab.valid]
    lib_ms = event_timer(torch, lambda: torch.isin(vals, live), 10)
    C, B = tab.col0.shape[0], vals.shape[0]
    nslots = ip.device_set(tab, ct).slots.shape[0]
    res = {"ms": b_ms + l_ms, "build_ms": b_ms, "lookup_ms": l_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "shape": f"{C}-row table, {B} probes"}
    # the function's bytes: the column and valid flags once, each operand
    # once, each result once (the set is the kernel's own)
    res.update(bound(C * (8 + 1) + B * (8 + 1)))
    print(f"timing K14 at IN1's shape ({res['shape']}): build {b_ms:.4f} ms "
          f"({nslots} slots) + lookup {l_ms:.4f} ms = {res['ms']:.4f} ms; "
          f"plain dense compare {plain_ms:.3f} ms; torch.isin over the "
          f"valid rows {lib_ms:.4f} ms; bound {res['bound_ms']:.5f} ms by "
          f"{res['bound_by']} ({res['bytes']} bytes)")
    return err, res


def watch_rt(dev, ql, rows, rng, np):
    """A runtime whose Watch table holds `rows` ids (every other id of
    [0, 2 * rows)), written through its WatchIn stream."""
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    rt.start()
    ids = rng.permutation(np.arange(0, 2 * rows, 2, dtype=np.int64))
    rt.get_input_handler("WatchIn").send_columns(
        [ids], timestamps=np.full(rows, 1, np.int64))
    return rt


WATCH_DEF = """
define stream WatchIn (k long);
@capacity(rows='65536')
define table Watch (k long);
from WatchIn insert into Watch;
"""


def compare_op_in(torch, np, dev):
    """Phase 25b: the bytecode's IN inside K1 (IN1's filter), pattern_step
    (the flagship with e1 probing a 65,536-row table at the 2^20-key slab,
    131,072 keys x 4 events), K8 (S1-wide with a probe) and K11 (P1 with
    a probe) against their plain versions, exact; each timed beside the
    same kernel on a query without the probe.  Returns the largest
    difference (0.0, or the comparison fails)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import filter_compact as fc
    from siddhi_tpu_torch.kernels import keyed_window as kw
    from siddhi_tpu_torch.kernels import pattern_step as ps
    rng = np.random.default_rng(73)
    err, times = 0.0, []

    # -- K1 at IN1's shape ----------------------------------------------------
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(IN1_QL)
    rt.start()
    perm = rng.permutation(T1_ROWS).astype(np.int64)
    for i in range(IN1_FILL):
        ids = perm[i * T1_B:(i + 1) * T1_B]
        rt.get_input_handler("StockUpdate").send_columns(
            [ids, rng.random(T1_B, np.float32),
             rng.integers(0, 1 << 40, T1_B).astype(np.int64)],
            timestamps=np.full(T1_B, 1000 + i, np.int64))
    p = rt.query_runtimes["known"].planned
    spec = p.filter_spec.bind(rt.in_probe_tables(p.in_deps))
    trades = [rng.integers(0, T1_ROWS + T1_MISS, T1_B).astype(np.int64),
              rng.random(T1_B, np.float32)]
    ts, kind, valid, gslot, dcols = staged_rows(
        torch, np, dev, p.in_schema.types, np.full(T1_B, 5000), T1_B,
        cols=trades)
    ra, na = fc.launch(spec, ts, kind, valid, gslot, dcols)
    rb, nb = fc.plain(spec, ts, kind, valid, gslot, dcols, 0)
    torch.cuda.synchronize()
    err = max(err, rows_err(torch, ra, rb, "K1 IN1 filter", full=True),
              float_err(torch, na, nb, "K1 IN1 count"))
    n_in = int(na)
    want = int(np.isin(trades[0], perm[:IN1_FILL * T1_B]).sum())
    if n_in != want:
        fail(f"K1 with IN: {n_in} trades kept, numpy {want}")
    plain_spec = fc.FilterSpec(spec.types, [], [], spec.scope_key)
    k_in = graph_ms(torch, lambda: fc.launch(spec, ts, kind, valid, gslot,
                                             dcols), 20)
    k_no = graph_ms(torch, lambda: fc.launch(plain_spec, ts, kind, valid,
                                             gslot, dcols), 20)
    times.append(f"K1 with `symbol in StockTable` at IN1's shape "
                  f"({T1_B} trades, a 2^20-row table, {n_in} kept) "
                  f"{k_in:.4f} ms; the same K1 with no filter "
                  f"{k_no:.4f} ms")
    print(f"compare: K1 with IN == plain at IN1's shape ({n_in} of {T1_B} "
          f"kept, = numpy)")
    del rt

    # -- pattern_step: the flagship with e1 probing Watch ----------------------
    K = N_KEYS
    rtp = watch_rt(dev, FLAGSHIP_IN_QL.format(n_keys=K), WATCH_ROWS, rng, np)
    planned = rtp.query_runtimes["flagship"].planned
    in_tabs = rtp.in_probe_tables(planned.exec.in_deps)
    a_state = planned.init_state(K)[0]
    b_state = clone_state(a_state)
    for it, (dense, E) in enumerate(((True, 4), (False, 4), (True, 4),
                                     (True, 1))):
        cols, tsw, _, sel, key_ref, now = random_step_inputs(
            rng, torch, dev, planned.in_schemas["TradeStream"].types, K,
            BATCH, E, dense)
        cols = (cols[0] % (4 * WATCH_ROWS),) + cols[1:]
        step = (planned.dense_steps_w if dense else planned.steps_w)[
            "TradeStream"]
        a = step.plain(a_state, (), cols, *tsw, sel, key_ref, now,
                       in_tabs=in_tabs)
        b = step.kernel(b_state, (), cols, *tsw, sel, key_ref, now,
                        in_tabs=in_tabs)
        torch.cuda.synchronize()
        e, hdr = compare_steps(torch, a, b, f"pattern_step with IN step {it}",
                               True)
        err = max(err, e)
        a_state, b_state = a[0], b[0]
        print(f"compare: pattern_step with IN step {it} "
              f"({'dense' if dense else 'gather'}, E={E}) == plain, header "
              f"{hdr}")
        if it == 0:
            t_args = (cols, tsw, sel, key_ref, now)
    base = SiddhiManager(device=dev).create_siddhi_app_runtime(
        FLAGSHIP_QL.format(n_keys=K)).query_runtimes["flagship"].planned
    cols, tsw, sel, key_ref, now = t_args
    saved = clone_state(b_state)

    def restore():
        restore_into(b_state, saved)
    kp_in = planned.dense_steps_w["TradeStream"].kernel_plan
    kp_no = base.dense_steps_w["TradeStream"].kernel_plan
    t_in = event_timer(torch, lambda: ps.launch(
        kp_in, b_state, cols, None, tsw, sel, key_ref, now, True,
        in_tabs=in_tabs), 10, restore)
    t_no = event_timer(torch, lambda: ps.launch(
        kp_no, b_state, cols, None, tsw, sel, key_ref, now, True), 10,
        restore)
    times.append(f"pattern_step with e1 probing a {WATCH_ROWS}-row table "
                  f"(2^20-key slab, {BATCH} keys x 4 events) {t_in:.4f} ms; "
                  f"the flagship's step without it {t_no:.4f} ms")
    del rtp, a_state, b_state, saved, base
    torch.cuda.empty_cache()

    # -- K8: S1-wide with e1 probing Watch ---------------------------------------
    rtb = watch_rt(dev, S1_IN_QL, WATCH_ROWS, rng, np)
    planned = rtb.query_runtimes["q"].planned
    in_tabs = rtb.in_probe_tables(planned.exec.in_deps)
    if not planned.block:
        fail("S1-wide with IN: not planned onto the block NFA")
    state = planned.init_state(1)[0]
    for i in range(2):
        cols, tsv = s1_send(np, rng, i, S1W_B)
        cols[0] = rng.integers(0, 4 * WATCH_ROWS, S1W_B).astype(np.int64)
        args = block_inputs(torch, np, dev, cols, tsv)
        step = planned.steps_w["S"]
        a = step.plain(clone_state(state), (), *args, in_tabs=in_tabs)
        b = step.kernel(state, (), *args, in_tabs=in_tabs)
        torch.cuda.synchronize()
        e, hdr = compare_steps(torch, a, b, f"K8 with IN step {i}", False)
        err = max(err, e)
        state = b[0]
        print(f"compare: K8 with IN (S1-wide) step {i} == plain, header "
              f"{hdr}")
    saved = clone_state(state)
    from siddhi_tpu_torch.kernels import block_nfa
    base = SiddhiManager(device=dev).create_siddhi_app_runtime(
        S1_QL.format(rows=65536)).query_runtimes["q"].planned
    bargs = args

    def restore_b():
        restore_into(state, saved)
    t_in = event_timer(torch, lambda: block_nfa.launch(
        planned.steps_w["S"].kernel_plan, state, bargs[0], None,
        bargs[1:3], bargs[3], bargs[5], in_tabs), 5, restore_b)
    t_no = event_timer(torch, lambda: block_nfa.launch(
        base.steps_w["S"].kernel_plan, state, bargs[0], None, bargs[1:3],
        bargs[3], bargs[5]), 5, restore_b)
    times.append(f"K8 with e1 probing a {WATCH_ROWS}-row table (S1-wide, "
                  f"{S1W_B} events) {t_in:.4f} ms; S1-wide's K8 without it "
                  f"{t_no:.4f} ms")
    del rtb

    # -- K11: P1 with a probe before the window ----------------------------------
    rtk = watch_rt(dev, P1_IN_QL, WATCH_ROWS, rng, np)
    planned = rtk.query_runtimes["p1"].planned
    spec = planned.filter_spec.bind(rtk.in_probe_tables(planned.in_deps))
    slabs = [planned.init_state()[0] for _ in range(2)]
    for i in range(3):
        cols, tsv = p1_send(np, rng, i)
        cols[0] = cols[0] % (4 * WATCH_ROWS)
        args = keyed_args(torch, np, dev, planned, cols, tsv)
        ra, wa = kw.launch(slabs[0], spec, *args, tick=False)
        rb, wb = kw.plain(slabs[1], spec, *args)
        torch.cuda.synchronize()
        err = max(err, rows_err(torch, ra, rb, f"K11 with IN step {i}",
                                full=True),
                  float_err(torch, wa, wb, f"K11 with IN step {i} wake"),
                  slab_err(torch, slabs[0], slabs[1],
                           f"K11 with IN step {i}"))
        print(f"compare: K11 with IN (P1 shape) step {i} == plain, "
              f"{int(ra.ts.shape[0])} rows")
    from siddhi_tpu_torch.kernels.filter_compact import FilterSpec
    no_spec = FilterSpec(spec.types, [], [], spec.scope_key)
    n_out = int(ra.ts.shape[0])
    t_in = event_timer(torch, lambda: kw.launch(slabs[0], spec, *args,
                                                n_out=None), 5)
    t_no = event_timer(torch, lambda: kw.launch(slabs[0], no_spec, *args,
                                                n_out=None), 5)
    times.append(f"K11 with `deviceID in Watch` at P1's shape ({P1_B} "
                  f"events, about {n_out} rows out) {t_in:.4f} ms; the same "
                  f"step without the probe {t_no:.4f} ms (each launch "
                  f"includes K11's fetch of its output size)")
    del rtk, slabs
    torch.cuda.empty_cache()
    for line in times:
        print(f"timing OP_IN: {line}")
    return err


def tb_arrivals(torch, np, dev, types, cols, ts):
    """A batch compacted as filter_compact leaves it (every row kept),
    with its count: K12's arrivals."""
    n = len(ts)
    tsd = torch.from_numpy(np.asarray(ts, np.int64)).to(dev)
    from siddhi_tpu_torch.core.window import Rows
    dcols = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                  for c in cols)
    return Rows(ts=tsd, kind=torch.zeros(n, dtype=torch.int32, device=dev),
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                seq=torch.zeros(n, dtype=torch.int64, device=dev),
                gslot=torch.from_numpy((np.asarray(cols[0]) % W1_KEYS)
                                       .astype(np.int32)).to(dev),
                cols=dcols), torch.tensor([n], dtype=torch.int64,
                                           device=dev)


def tb_state_err(torch, a, b, what):
    err = float_err(torch, a.meta, b.meta, f"{what} meta")
    for sa, sb in zip(a.slices(), b.slices()):
        err = max(err, float_err(torch, sa[0], sb[0], f"{what} ts"),
                  float_err(torch, sa[1], sb[1], f"{what} gslot"))
        for x, y in zip(sa[2], sb[2]):
            err = max(err, float_err(torch, x, y, f"{what} col"))
    return err


def w1_send(np, rng, i):
    """W1's readings of send i: devices uniform over 4,000, roomNo =
    deviceID mod 100, temperatures uniform over [15, 35), event time
    spread over the send's 75 s."""
    ids = rng.integers(0, W1_KEYS, W1_B).astype(np.int64)
    temp = (15 + 20 * rng.random(W1_B)).astype(np.float32)
    ts = 1000 + W1_DT * i + np.arange(W1_B, dtype=np.int64) * W1_DT // W1_B
    return [ids, (ids % 100).astype(np.int32), temp], ts


def compare_time_batch_order(torch, np, dev):
    """Phase 25c: K12 against its plain version at W1's shape (two
    buffers of 2^21 rows) on filling steps, a flush step with a full
    previous slice, a step with out-of-order timestamps, a TIMER step
    that flushes, one that flushes an empty slice; then K13 at the
    flush's 2,097,153 rows (avgTemp desc limit 10, and the two-key order
    of the query guide's Order By example) and at keys holding -0.0,
    NaN and int nulls, every output exact.  Returns (err12, err13,
    timing)."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.window import BatchFacts
    from siddhi_tpu_torch.kernels import order_limit as ol
    from siddhi_tpu_torch.kernels import time_batch as tb
    schema = w1_schema()
    C = 1 << 21
    states = [tb.TimeBatchState.empty(schema, C, dev) for _ in range(2)]
    rng = np.random.default_rng(79)
    err12, timing = 0.0, {}
    t = 600_000
    steps = [("fill", i) for i in range(8)] + [("flush", 8)] + \
        [("fill", i) for i in range(9, 16)] + [("flush", 16)] + \
        [("fill", i) for i in range(17, 23)] + [("ooo", 23), ("ooo", 24),
                                                ("timer", 0), ("timer", 1)]
    last_flush = None
    for j, (what, i) in enumerate(steps):
        if what == "timer":
            now = 1000 + W1_DT * 25 + t * (i + 1)
            cols = [np.zeros(8, np.int64), np.zeros(8, np.int32),
                    np.zeros(8, np.float32)]
            ts = np.full(8, now, np.int64)
            arr, n_arr = tb_arrivals(torch, np, dev, schema.types, cols, ts)
            n_arr.zero_()
            cur = np.zeros(0, np.int64)
        else:
            cols, ts = w1_send(np, rng, i)
            if what == "ooo":
                    ts = ts[rng.permutation(W1_B)] - rng.integers(
                    0, 2 * W1_DT, W1_B)
            now = int(ts.max())
            arr, n_arr = tb_arrivals(torch, np, dev, schema.types, cols, ts)
            cur = ts
        facts = BatchFacts(cur, len(ts))
        cap = [tb.out_capacity(s, cur, now, t, True) for s in states]
        if cap[0] != cap[1]:
            fail("K12: host sizes differ")
        before = states[0].clone()
        ra, wa = tb.launch(states[0], arr, n_arr, now, t, cap[0])
        rb, wb = tb.plain(states[1], arr, n_arr, now, t, cap[1])
        torch.cuda.synchronize()
        label = f"K12 step {j} ({what})"
        err12 = max(err12, rows_err(torch, ra, rb, label, full=True),
                    float_err(torch, wa, wb, f"{label} wake"),
                    tb_state_err(torch, states[0], states[1], label))
        n_rows = int(ra.valid.sum())
        print(f"compare: {label}: K12 == plain, {n_rows} rows of "
              f"{cap[0]}, wake {[int(x) for x in wb]}")
        if what == "flush" and i == 16:      # a steady flush: both slices
            timing["flush"] = (before, arr, n_arr, now, cap[0], n_rows)
            last_flush = ra
        if what == "fill" and i == 9:
            timing["fill"] = (before, arr, n_arr, now, cap[0], 0)
        del facts
    # -- K13 on the flush's rows -----------------------------------------------
    out_rows = last_flush
    nflush = out_rows.ts.shape[0]
    avg = torch.from_numpy(
        (15 + 20 * rng.random(nflush)).astype(np.float32)).to(dev)
    avg[rng.random(nflush) < 0.3] = 25.0        # ties
    room = torch.from_numpy(rng.integers(0, 100, nflush).astype(np.int32)) \
        .to(dev)
    kinds = out_rows.kind
    valid = out_rows.valid & (kinds != ev.RESET)
    err13 = compare_order_modes(torch, np, dev, rng, out_rows, kinds, valid,
                                avg, room)
    cols = (avg, room, out_rows.cols[0])
    timing["order"] = ([(avg, True)], out_rows.ts, kinds, valid, cols, avg)
    return err12, err13, timing


def compare_order_modes(torch, np, dev, rng, out_rows, kinds, valid, avg,
                        room):
    """K13 against its plain version at W1's flush (2,097,153 rows), every
    output exact, in both modes: top-k (avgTemp desc limit 10, 1 and
    M = TOPK_MAX; the query guide's two-key order; an int64 key; -0.0,
    NaN and int nulls; three keys in three words) and sort (limit M offset
    1, no limit, the two-key order composed into one word, an int64 key,
    an offset past the valid count, the nulls), limit 0, and 2^21 rows
    whose keys are all equal with limit 10 offset 5 (rows 5-14 out).
    Returns the max error."""
    from siddhi_tpu_torch.kernels import order_limit as ol
    t0 = time.perf_counter()
    nflush = out_rows.ts.shape[0]
    nvalid = int(valid.sum())
    cols = (avg, room, out_rows.cols[0])
    dev_id = out_rows.cols[0]
    spec_vals = np.array([0.0, -0.0, np.nan, 1.0, -1.0, np.inf, -np.inf],
                         np.float32)
    f_sp = torch.from_numpy(rng.choice(spec_vals, nflush)).to(dev)
    i_sp = torch.from_numpy(rng.choice(np.array(
        [np.iinfo(np.int32).min, 0, 1, -1, 7], np.int32), nflush)).to(dev)
    l_sp = torch.from_numpy(rng.choice(np.array(
        [np.iinfo(np.int64).min, 0, 5, -5], np.int64), nflush)).to(dev)
    b_sp = torch.from_numpy(rng.random(nflush) < 0.5).to(dev)
    M = ol.TOPK_MAX
    nulls = [(i_sp, True), (l_sp, False), (b_sp, True)]
    cases = [("avgTemp desc limit 10", [(avg, True)], 0, 10),
             ("avgTemp desc limit 1", [(avg, True)], 0, 1),
             (f"avgTemp desc limit {M} (m = M)", [(avg, True)], 0, M),
             (f"avgTemp desc limit {M} offset 1 (m = M + 1)", [(avg, True)],
              1, M),
             ("avgTemp desc (no limit)", [(avg, True)], 0, None),
             ("avgTemp, roomNo desc", [(avg, False), (room, True)], 0, None),
             ("avgTemp, roomNo desc limit 100 offset 7",
              [(avg, False), (room, True)], 7, 100),
             ("deviceID limit 10 (int64)", [(dev_id, False)], 0, 10),
             ("deviceID desc (int64)", [(dev_id, True)], 0, None),
             ("offset past the valid count", [(avg, True)], nvalid + 3, None),
             ("limit 10 offset past the valid count", [(avg, True)],
              nvalid + 3, 10),
             ("limit 0", [(avg, True)], 0, 0),
             ("-0.0 / NaN desc, int nulls", [(f_sp, True), (i_sp, False)],
              3, 1000),
             ("-0.0 / NaN desc, int nulls limit 200 offset 3",
              [(f_sp, True), (i_sp, False)], 3, 200),
             ("int nulls desc, long nulls, bool", nulls, 0, None),
             ("int nulls desc, long nulls, bool limit 50", nulls, 0, 50)]
    err13 = 0.0

    def held(label, keys, lo, lim, ts, kind, vd, cs):
        nonlocal err13
        a = ol.launch(keys, lo, lim, ts, kind, vd, cs)
        b = ol.plain(keys, lo, lim, ts, kind, vd, cs)
        torch.cuda.synchronize()
        for x, y, f in zip(a[:3], b[:3], ("ts", "kind", "valid")):
            err13 = max(err13, float_err(torch, x, y, f"K13 {label} {f}"))
        for j, (x, y) in enumerate(zip(a[3], b[3])):
            err13 = max(err13, float_err(torch, x, y, f"K13 {label} col {j}"))
        md = ol.mode(ts.shape[0], lo, lim)[0]
        print(f"compare: K13 ({label}, {md} mode) == plain over "
              f"{ts.shape[0]} rows, {int(a[2].sum())} kept of "
              f"{a[2].shape[0]}")
        return a
    for label, keys, lo, lim in cases:
        held(label, keys, lo, lim, out_rows.ts, kinds, valid, cols)
    # 2^21 rows, every key equal: ties cross every block; rows 5-14 out
    n = 1 << 21
    ts = torch.arange(n, dtype=torch.int64, device=dev)
    same = torch.full((n,), 3.5, dtype=torch.float32, device=dev)
    a = held("2^21 equal keys limit 10 offset 5", [(same, True)], 5, 10, ts,
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev), (same,))
    if a[0].tolist() != list(range(5, 15)):
        fail(f"K13: equal keys, limit 10 offset 5 gave rows {a[0].tolist()}")
    empty = ol.launch([(avg[:0], True)], 0, 10, out_rows.ts[:0], kinds[:0],
                      valid[:0], tuple(c[:0] for c in cols))
    if empty[0].shape[0] != 0:
        fail("K13 on no rows")
    print(f"compare: K13's cases took {time.perf_counter() - t0:.1f} s")
    return err13


def w1_schema():
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.query_api.definition import StreamDefinition
    d = StreamDefinition("TempStream")
    for n, tp in (("deviceID", "LONG"), ("roomNo", "INT"),
                  ("temp", "DOUBLE")):
        d.attribute(n, tp)
    return ev.Schema(d, ev.StringInterner())


def time_time_batch_order(torch, np, dev, timing):
    """Phase 25d: K12 at W1's flush and at a filling step (from restored
    states), K13 at the flush's rows, beside their plain versions, their
    bounds and, for K13, torch.sort(stable=True) of the key."""
    from siddhi_tpu_torch.kernels import order_limit as ol
    from siddhi_tpu_torch.kernels import time_batch as tb
    res = {}
    t = 600_000
    for what in ("flush", "fill"):
        before, arr, n_arr, now, cap, n_rows = timing[what]
        st = before.clone()

        def restore(_s=st, _b=before):
            _s.meta.copy_(_b.meta)
        k_ms = graph_ms(torch, lambda: tb.launch(st, arr, n_arr, now, t,
                                                 cap), 10, restore)
        p_ms = event_timer(torch, lambda: tb.plain(st, arr, n_arr, now, t,
                                                   cap), 3, restore)
        B = arr.ts.shape[0]
        _, _, pf, qf = (int(x) for x in before.meta[:4].tolist())
        row = 8 + 4 + 8 + 4 + 4            # ts, slot, the three columns
        out_row = 8 + 4 + 1 + 8 + 4 + 16   # ts, kind, valid, seq, slot, cols
        # the slices read once, the arrivals read and written once, each
        # output row written once
        nbytes = 2 * B * row + ((qf + pf) * row + n_rows * out_row
                                if what == "flush" else 0)
        r = {"ms": k_ms, "plain_ms": p_ms, "rows": n_rows,
             "shape": f"{what} step, {B} arrivals, {n_rows} rows out"}
        r.update(bound(nbytes))
        res[what] = r
        print(f"timing K12 ({r['shape']}): {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']} ({r['bytes']} bytes)")
    keys, ts, kinds, valid, cols, avg = timing["order"]
    n, N = int(valid.sum()), valid.shape[0]
    key = -avg                      # the order's key: avgTemp desc
    lib_sort = event_timer(torch, lambda: torch.sort(key, stable=True), 10)
    out_row = 8 + 4 + 1 + 4 + 4 + 8     # ts, kind, valid, the three columns
    modes = {}
    for md, lim in (("topk", 10), ("sort", None)):
        k_ms = graph_ms(torch, lambda: ol.launch(keys, 0, lim, ts, kinds,
                                                 valid, cols), 10)
        p_ms = event_timer(torch, lambda: ol.plain(keys, 0, lim, ts, kinds,
                                                   valid, cols), 3)
        kept = n if lim is None else lim
        # the valid flags and each valid row's key once, the kept rows read
        # and written
        r = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_sort,
             "library": "torch.sort(stable=True) of the key",
             "shape": f"W1's flush, {n} valid rows, one f32 key, "
                      f"{'limit 10' if lim else 'no limit'}"}
        r.update(bound(N + n * 4 + 2 * kept * out_row))
        line = (f"timing K13 {md} mode ({r['shape']}): {k_ms:.4f} ms, plain "
                f"{p_ms:.3f} ms, torch.sort(stable=True) of the key "
                f"{lib_sort:.4f} ms")
        if md == "topk":
            r["library_topk_ms"] = event_timer(
                torch, lambda: torch.topk(key, 10, largest=False), 10)
            line += (f", torch.topk(k=10, largest=False) of the key (not "
                     f"tie-stable) {r['library_topk_ms']:.4f} ms")
        print(f"{line}, bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
              f"({r['bytes']} bytes)")
        modes[md] = r
    res["order"] = dict(modes["topk"], modes=modes)
    return res


class W1Model:
    """The reference's semantics for W1, in numpy: per device, f32 running
    sums and int counts in row order (K4 scans each segment left to
    right), the flush's EXPIRED rows (the previous slice, subtracting)
    before its RESET, its CURRENT rows (the flushed slice, from zero)
    after; avg = f32(sum) / f32(count); a stable sort by -avg (NaN last);
    the first 10 rows, CURRENT and EXPIRED alike; then the CURRENT cut."""

    def __init__(self, np):
        self.np = np
        self.s = np.zeros(W1_KEYS, np.float32)
        self.c = np.zeros(W1_KEYS, np.int64)

    def _run(self, ids, temp, sign):
        np = self.np
        order = np.argsort(ids, kind="stable")
        sid, st = ids[order], temp[order] * np.float32(sign)
        bounds = np.flatnonzero(np.diff(sid)) + 1
        s_out = np.empty(ids.shape[0], np.float32)
        c_out = np.empty(ids.shape[0], np.int64)
        for seg in np.split(np.arange(ids.shape[0]), bounds):
            if not seg.size:
                continue
            g = sid[seg[0]]
            acc = np.add.accumulate(np.concatenate(
                [[self.s[g]], st[seg]]).astype(np.float32), dtype=np.float32)
            s_out[order[seg]] = acc[1:]
            c_out[order[seg]] = self.c[g] + sign * np.arange(1, seg.size + 1)
            self.s[g] = acc[-1]
            self.c[g] = c_out[order[seg[-1]]]
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = np.where(c_out != 0, s_out / c_out.astype(np.float32),
                           np.float32(np.nan)).astype(np.float32)
        return avg

    def slice_totals(self, ids, temp):
        """The carry a flushed slice leaves: its CURRENT rows from zero."""
        self.s[:] = 0
        self.c[:] = 0
        self._run(ids, temp, 1)

    def flush(self, prev, cur):
        """The delivered rows of a flush: (avgTemp, roomNo, deviceID)."""
        np = self.np
        a_exp = self._run(prev[0], prev[1], -1)
        self.s[:] = 0
        self.c[:] = 0
        a_cur = self._run(cur[0], cur[1], 1)
        avg = np.concatenate([a_exp, a_cur])
        kind = np.concatenate([np.ones(a_exp.shape[0], np.int32),
                               np.zeros(a_cur.shape[0], np.int32)])
        ids = np.concatenate([prev[0], cur[0]])
        key = np.where(np.isnan(avg), np.inf, -avg.astype(np.float64))
        top = np.argsort(key, kind="stable")[:10]
        top = top[kind[top] == 0]
        return [(float(avg[r]), int(ids[r] % 100), int(ids[r]))
                for r in top]


def run_w1(torch, np, dev, mods):
    """W1: the query guide's Limit & Offset example at 4,000 devices,
    131,072 readings a send, 75 s of event time a send: 8 filling sends,
    32 timed (4 flushes, each of 1,048,576 EXPIRED rows, a RESET row and
    1,048,576 CURRENT rows through K4 and K13), 8 checked, whose flush's
    delivered rows are held to W1Model.  Returns (K12, K13 launches)."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(W1_QL)
    got = []
    rt.add_callback("w1", lambda ts, i, o: got.append(
        [tuple(e.data) for e in i or []]))
    rt.start()
    h = rt.get_input_handler("TempStream")
    rng = np.random.default_rng(83)
    n = W1_FILL + W1_TIMED + W1_CHECK
    sends = [w1_send(np, rng, i) for i in range(n)]
    for m in mods.values():
        m.reset_counts()
    lat, t0 = [], None
    for i, (cols, ts) in enumerate(sends):
        if i == W1_FILL:
            rt.flush()
            t0 = time.perf_counter()
        if i == W1_FILL + W1_TIMED:
            rt.flush()
            wall = time.perf_counter() - t0
            got.clear()
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if W1_FILL <= i < W1_FILL + W1_TIMED:
            lat.append(time.perf_counter() - tb)
    rt.flush()
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("W1", launches, plain, ("time_batch", "group_agg",
                                          "order_limit"))
    # the checked flush (at send W1_FILL + W1_TIMED) expires the slice of
    # the 8 sends before the 8 it flushes
    k = W1_FILL + W1_TIMED
    flushed = [np.concatenate([sends[j][0][c] for j in range(k - 8, k)])
               for c in (0, 2)]
    prev = [np.concatenate([sends[j][0][c] for j in range(k - 16, k - 8)])
            for c in (0, 2)]
    model = W1Model(np)
    model.slice_totals(*prev)
    want = model.flush(prev, flushed)
    rows = [r for b in got for r in b]
    if len(got) != 1 or rows != want:
        fail(f"W1: the checked flush delivered {rows[:12]} in {len(got)} "
             f"batches; the model {want}")
    lat_line(np, "W1 (timeBatch(10 min), 4,000 groups, avg desc limit 10)",
             lat, wall, W1_B * W1_TIMED, W1_B * (8 + 4 + 4 + 8 + 4))
    print(f"W1 check: the checked flush's {len(want)} delivered rows (of the "
          f"top 10 over its 1,048,576 EXPIRED and 1,048,576 CURRENT rows) "
          f"equal the numpy model; launches {launches}")
    extra = [w1_send(np, rng, n + j) for j in range(8)]

    def send(b):
        h.send_columns(*extra[b])
    profile = device_profile(torch, rt, 8, send)
    profile_line("W1", 8, profile)
    mgr.shutdown()
    return launches


def run_in1(torch, np, dev, mods):
    """IN1: T1's upsert app with the query guide's `in` condition as a
    second query: 8 filling sends, then 16 timed sends of 131,072 upserts
    and 131,072 trades (ids over 2^20 + 2^16); every send's delivered
    symbols equal np.isin over the numpy table model.  The table changes
    every send, so K14 rebuilds its set every send.  Returns K14's
    launches."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(IN1_QL)
    got = []
    rt.add_batch_callback("known", lambda ts, b: got.append(b))
    rt.start()
    rng = np.random.default_rng(89)
    perm = rng.permutation(T1_ROWS).astype(np.int64)
    present = np.zeros(T1_ROWS + T1_MISS, bool)
    for m in mods.values():
        m.reset_counts()
    lat, t0, checked = [], None, 0
    for i in range(IN1_FILL + IN1_TIMED):
        if i == IN1_FILL:
            rt.flush()
            t0 = time.perf_counter()
        ts = np.full(T1_B, 1000 + 10 * i, np.int64)
        ids = perm[i * T1_B:(i + 1) * T1_B] if i < IN1_FILL else \
            rng.integers(0, T1_ROWS, T1_B).astype(np.int64)
        up = [ids, rng.random(T1_B, np.float32),
              rng.integers(0, 1 << 40, T1_B).astype(np.int64)]
        trades = [rng.integers(0, T1_ROWS + T1_MISS, T1_B).astype(np.int64),
                  rng.random(T1_B, np.float32)]
        tb = time.perf_counter()
        rt.get_input_handler("StockUpdate").send_columns(up, timestamps=ts)
        rt.get_input_handler("TradeStream").send_columns(trades,
                                                         timestamps=ts + 1)
        if i >= IN1_FILL:
            lat.append(time.perf_counter() - tb)
        present[ids] = True
        b = got[-1] if got else None
        sym = np.asarray(b["cols"]["symbol"])[b["valid"]] if b else \
            np.zeros(0, np.int64)
        want = trades[0][present[trades[0]]]
        if not np.array_equal(sym, want):
            fail(f"IN1 send {i}: {sym.shape[0]} delivered symbols, numpy "
                 f"{want.shape[0]}")
        checked += 1
        got.clear()
    rt.flush()
    wall = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("IN1", launches, plain, ("in_probe", "filter_compact",
                                           "table_match", "table_write"))
    lat_line(np, "IN1 (upserts + `symbol in StockTable` at 2^20 rows)", lat,
             wall, 2 * T1_B * IN1_TIMED, 2 * T1_B * (8 + 4 + 8 + 8))
    print(f"IN1 check: every one of {checked} sends delivered exactly the "
          f"trades numpy's isin finds in the table model; K14 launches "
          f"{launches['in_probe']}")
    extra = []
    for j in range(4):
        ts = np.full(T1_B, 9000 + j, np.int64)
        extra.append(([rng.integers(0, T1_ROWS, T1_B).astype(np.int64),
                       rng.random(T1_B, np.float32),
                       rng.integers(0, 1 << 40, T1_B).astype(np.int64)],
                      [rng.integers(0, T1_ROWS + T1_MISS, T1_B)
                       .astype(np.int64), rng.random(T1_B, np.float32)],
                      ts))

    def send(b):
        up, tr, ts = extra[b]
        rt.get_input_handler("StockUpdate").send_columns(up, timestamps=ts)
        rt.get_input_handler("TradeStream").send_columns(tr,
                                                         timestamps=ts + 1)
    profile = device_profile(torch, rt, 4, send)
    profile_line("IN1", 4, profile)
    mgr.shutdown()
    return launches


def run_j1g(torch, np, dev, mods):
    """J1G: J1's windowed join with group by L.symbol and sum(R.qty) (the
    joined row's R.qty projected beside it): 1 warm + 16 timed sends of
    8,192 events a side; every delivered row, CURRENT and EXPIRED, holds
    its symbol's running sum over the join's rows in emission order
    (+qty CURRENT, -qty EXPIRED; null when no row is left), as numpy
    accumulates it."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(J1G_QL)
    got = []
    rt.add_batch_callback("q", lambda ts, b: got.append(b))
    rt.start()
    sends = j1_sends(np, np.random.default_rng(97), 1 + J1G_TIMED)
    for m in mods.values():
        m.reset_counts()
    lat, t0 = [], None
    run = np.zeros(J1_SYM, np.int64)
    cnt = np.zeros(J1_SYM, np.int64)
    rows = 0
    for i, (stream, cols, ts) in enumerate(sends):
        if i == 2:
            rt.flush()
            t0 = time.perf_counter()
        tb = time.perf_counter()
        rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
        if i >= 2:
            if stream == "L":
                lat.append(time.perf_counter() - tb)
            else:
                lat[-1] += time.perf_counter() - tb
    rt.flush()
    wall = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    for b in got:
        v = np.asarray(b["valid"])
        kind = np.asarray(b["kind"])[v]
        s = np.asarray(b["cols"]["s"])[v]
        q = np.asarray(b["cols"]["q"])[v].astype(np.int64)
        total = np.asarray(b["cols"]["total"])[v]
        sign = np.where(kind == 0, 1, -1)
        want = np.empty_like(total)
        for r in range(s.shape[0]):
            run[s[r]] += sign[r] * q[r]
            cnt[s[r]] += sign[r]
            # sum is null once the window retracts every contribution
            want[r] = run[s[r]] if cnt[s[r]] else np.iinfo(np.int64).min
        if not np.array_equal(total, want):
            bad = int(np.flatnonzero(total != want)[0])
            fail(f"J1G: row {rows + bad}: total {total[bad]}, numpy "
                 f"{want[bad]}")
        rows += s.shape[0]
    check_launched("J1G", launches, plain, ("group_agg", "join_probe",
                                           "filter_compact"))
    lat_line(np, "J1G (J1 with group by L.symbol, sum(R.qty))", lat, wall,
             2 * J1_B * J1G_TIMED, 2 * J1_B * (8 + 4 + 8 + 4 + 4))
    print(f"J1G check: all {rows} delivered rows hold their symbol's "
          f"running sum in emission order")
    mgr.shutdown()
    return launches


def slice7_phases(torch, np, dev):
    """Phases 25-28: K14 and the IN opcode in K1 / pattern_step / K8 /
    K11 against their plain versions; K12 and K13 against theirs; their
    times; W1, IN1 and J1G through SiddhiManager.  Returns the K12, K13
    and K14 records."""
    from siddhi_tpu_torch.kernels import join_probe
    mods = slice7_modules()
    err14, t14 = compare_in_probe(torch, np, dev)
    err_in = compare_op_in(torch, np, dev)
    torch.cuda.empty_cache()
    err12, err13, timing = compare_time_batch_order(torch, np, dev)
    t12 = time_time_batch_order(torch, np, dev, timing)
    del timing
    torch.cuda.empty_cache()
    l_w1 = run_w1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    l_in1 = run_in1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    l_j1g = run_j1g(torch, np, dev, dict(mods, join_probe=join_probe))
    print(f"compare: OP_IN inside K1, pattern_step, K8 and K11 == plain, "
          f"max_abs_err {err_in}")
    records = []
    for name, t, n, err, rep, lib in (
            ("time_batch", t12["flush"], l_w1["time_batch"], err12,
             "siddhi_tpu/core/window.py:602", None),
            ("order_limit", t12["order"], l_w1["order_limit"], err13,
             "siddhi_tpu/core/selector.py:545", t12["order"]["library_ms"]),
            ("in_probe", t14, l_in1["in_probe"], max(err14, err_in),
             "siddhi_tpu/core/planner.py:471", t14["library_ms"])):
        why = "" if lib is not None else \
            "; library_ms null: no single PyTorch call computes a " \
            "tumbling-slice flush"
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} "
              f"bytes), plain {t['plain_ms']:.4f} ms, launches on the main "
              f"path {n}{why}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{name}.cu", "replaces": rep,
            "launches": n, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": lib})
        if "modes" in t:        # K13: top-k on the main path (W1), sort
            records[-1]["modes"] = {
                md: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms") +
                     (("library_topk_ms",) if md == "topk" else ())}
                for md, r in t["modes"].items()}
    print(f"J1G: K4 launches {l_j1g['group_agg']}")
    return records


# the Siddhi 5.1 query guide's Limit & Offset example with its TempStream,
# playback and a window that holds a 10-minute slice
W1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
@capacity(window='2097152')
@info(name='w1')
from TempStream#window.timeBatch(10 min)
select avg(temp) as avgTemp, roomNo, deviceID
group by roomNo, deviceID
order by avgTemp desc
limit 10
insert into HighestAvgTempStream;
"""

# T1's upsert (the query guide's Table section) and its `in` condition
IN1_QL = """
define stream StockUpdate (symbol long, price float, volume long);
define stream TradeStream (symbol long, price float);
@PrimaryKey('symbol') @capacity(rows='1048576')
define table StockTable (symbol long, price float, volume long);
@info(name='upsert') from StockUpdate select symbol, price, volume
update or insert into StockTable on StockTable.symbol == symbol;
@info(name='known') from TradeStream[symbol in StockTable]
select symbol, price insert into KnownTrades;
"""

# bench.py:261's J1 with group by (and the joined row's R.qty, so each
# delivered row shows its contribution)
J1G_QL = """
@app:playback
define stream L (symbol long, price float);
define stream R (symbol long, qty int);
@info(name='q')
from L#window.length(128) join R#window.length(128)
  on L.symbol == R.symbol
select L.symbol as s, R.qty as q, sum(R.qty) as total
group by L.symbol
insert all events into Out;
"""

FLAGSHIP_IN_QL = "@app:playback" + WATCH_DEF + """
define stream TradeStream (key long, price float, volume int);
partition with (key of TradeStream)
begin
  @capacity(keys='{n_keys}', slots='4')
  @emit(rows='2')
  @info(name='flagship')
  from every e1=TradeStream[volume == 1 and key in Watch]
       -> e2=TradeStream[volume == 2 and price >= e1.price]
       -> e3=TradeStream[volume == 3]
       -> e4=TradeStream[volume == 4 and price >= e3.price]
  select e1.key as k, e1.price as p1, e2.price as p2, e4.price as p4
  insert into Matches;
end;
"""

S1_IN_QL = "@app:playback" + WATCH_DEF + """
define stream S (symbol long, price float, volume int);
@capacity(keys='1', slots='8')
@emit(rows='65536')
@info(name='q')
from every e1=S[volume == 1 and symbol in Watch],
  e2=S[volume == 2 and price > e1.price]
  within 1 sec
select e1.price as p1, e2.price as p2
insert into M;
"""

P1_IN_QL = "@app:playback" + WATCH_DEF.replace(
    "(k long)", "(deviceID long)") + """
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (deviceID of TempStream)
begin
  @capacity(keys='1048576')
  @info(name='p1')
  from TempStream[deviceID in Watch]#window.length(10)
  select roomNo, deviceID, max(temp) as maxTemp
  insert into DeviceTempStream;
end;
"""


# ---------------------------------------------------------------------------
# phases 29-32: range partitions, @purge, keyed timeBatch (K11's timeBatch
# mode), filters after the window (K15 post_filter) and group_agg beyond
# 4,096 slots (K4's radix mode)
# ---------------------------------------------------------------------------

RP1_DEV, RP1_ROOMS, RP1_B = 10_000, 1500, 1 << 17
RP1_T = 600_000           # time(10 min)
RP1_FILL, RP1_TIMED, RP1_CHECK = 48, 16, 2
KT1_KEYS = 1 << 16        # KT1's devices (@capacity(keys='65536'))
KT1_T = 60_000            # timeBatch(1 min): 30 sends a slice
KT1_C = 128               # a key's slice capacity: max(128, 2 * 64)
KT1_FILL, KT1_CHECK, KT1_TIMED = 59, 2, 32
PG1_B, PG1_SHIFT, PG1_SPAN = 1 << 17, 1 << 14, 1 << 20
PG1_IDLE = 30_000         # @purge(idle.period='30 sec', interval='1 sec')
PG1_KEYS_CAP = 1 << 21    # @capacity(keys='2097152'): its group slots
PG1_FILL, PG1_TIMED, PG1_CHECK = 64, 32, 2
PF1_SYM = N_SYM
PF1_FILL, PF1_TIMED = 104, 16


def slice8_modules():
    from siddhi_tpu_torch.kernels import (filter_compact, group_agg,
                                          keyed_window, post_filter,
                                          time_window)
    return {"keyed_window": keyed_window, "group_agg": group_agg,
            "filter_compact": filter_compact, "post_filter": post_filter,
            "time_window": time_window}


def rp1_send(np, rng, i):
    """RP1's send i: readings i*B .. (i+1)*B - 1 of a stream in which
    each of RP1_DEV devices reads once a second (all at the second's
    timestamp, in device order); device d sits in room d * 1500 // DEV;
    temperatures are integers 0-3, so every window sum is exact."""
    j = i * RP1_B + np.arange(RP1_B, dtype=np.int64)
    dev = j % RP1_DEV
    room = (dev * RP1_ROOMS // RP1_DEV).astype(np.int32)
    temp = rng.integers(0, 4, RP1_B).astype(np.float32)
    return [dev, room, temp], 1000 + 1000 * (j // RP1_DEV)


def rp1_area(np, room):
    """The first range a room matches: 0 serverRoom, 1 officeRoom, 2
    lobby."""
    return np.where(room >= 1030, 0, np.where(room >= 330, 1, 2))


class RP1Model:
    """RP1's window per area in numpy: the alive readings in arrival order
    and their count and (exact) temperature sum."""

    def __init__(self, np, t):
        self.np, self.t = np, t
        self.rows = [[] for _ in range(3)]   # chunks (ts, device, temp)
        self.head = [0, 0, 0]                # rows of chunk 0 gone
        self.n = [0, 0, 0]
        self.sum = [0.0, 0.0, 0.0]

    def _expire(self, a, w):
        """Area a's rows with ts + t == w (a prefix), removed."""
        np = self.np
        out = []
        while self.rows[a]:
            ts, d, tp = self.rows[a][0]
            h = self.head[a]
            k = h + int(np.searchsorted(ts[h:], w - self.t, side="right"))
            out.append((ts[h:k], d[h:k], tp[h:k]))
            if k < ts.shape[0]:
                self.head[a] = k
                break
            self.rows[a].pop(0)
            self.head[a] = 0
        return [np.concatenate(x) for x in zip(*out)] if out else None

    def _oldest(self, a):
        return int(self.rows[a][0][0][self.head[a]]) if self.rows[a] \
            else None

    def _check(self, b, want, what):
        """The valid rows of one step: each area's rows together, in the
        rows' area order, as `want` = {area: (kind, ts, device, avg)}."""
        np = self.np
        v = b["valid"]
        area = rp1_area(np, b["cols"]["roomNo"][v])
        starts = np.r_[0, np.nonzero(area[1:] != area[:-1])[0] + 1] \
            if area.shape[0] else np.zeros(0, np.int64)
        order = [int(x) for x in area[starts]]
        if sorted(order) != sorted(want):
            fail(f"{what}: rows for areas {order}, expected {sorted(want)} "
                 f"(or an area's rows are not together)")
        got = (b["kind"][v], b["ts"][v], b["cols"]["deviceID"][v],
               b["cols"]["avgTemp"][v].view(np.int32))
        for j, name in enumerate(("kind", "ts", "deviceID", "avgTemp")):
            w = np.concatenate([want[a][j] for a in order])
            if name == "avgTemp":
                w = w.view(np.int32)
            if not np.array_equal(got[j], w):
                bad = np.nonzero(got[j] != w)[0][:3]
                fail(f"{what}: {name} differs at rows {bad}")

    def step(self, cols, ts, batches=None, what="RP1"):
        """Advances over one send: the TIMER ticks at each expiry time up
        to the send's time (one step each, expiring the readings of that
        second), then the data step.  With `batches` (the send's delivered
        steps) holds every row: EXPIRED rows with ts + t and the running
        avg after each removal, CURRENT rows with the running avg after
        each arrival.  Returns the number of ticks."""
        np = self.np
        now = int(ts.max())
        dev, room, temp = cols
        area = rp1_area(np, room)
        steps = [b for b in batches if b["n_valid"]] if batches is not None \
            else None
        ticks = 0
        while True:
            old = [self._oldest(a) for a in range(3)]
            due = [o + self.t for o in old if o is not None and
                   o + self.t <= now]
            if not due:
                break
            w = min(due)
            want = {}
            for a in range(3):
                if old[a] is None or old[a] + self.t != w:
                    continue
                e_ts, e_dev, e_tp = self._expire(a, w)
                cum = np.cumsum(e_tp, dtype=np.float64)
                cnt = self.n[a] - np.arange(1, e_ts.shape[0] + 1)
                avg = ((self.sum[a] - cum) / cnt).astype(np.float32)
                want[a] = (np.ones(e_ts.shape[0], np.int32), e_ts + self.t,
                           e_dev, avg)
                self.n[a] -= e_ts.shape[0]
                self.sum[a] -= float(cum[-1])
            if steps is not None:
                self._check(steps[ticks], want, f"{what} tick at {w}")
            ticks += 1
        want = {}
        for a in range(3):
            m = area == a
            if not m.any():
                continue
            cum = np.cumsum(temp[m], dtype=np.float64)
            cnt = self.n[a] + np.arange(1, int(m.sum()) + 1)
            avg = ((self.sum[a] + cum) / cnt).astype(np.float32)
            want[a] = (np.zeros(int(m.sum()), np.int32), ts[m], dev[m], avg)
            self.rows[a].append((ts[m], dev[m], temp[m]))
            self.n[a] += int(m.sum())
            self.sum[a] += float(cum[-1])
        if steps is not None:
            if len(steps) != ticks + 1:
                fail(f"{what}: {len(steps)} steps delivered rows, expected "
                     f"{ticks} ticks and the data step")
            self._check(steps[ticks], want, f"{what} data step")
        return ticks


def kt1_send(np, rng, i):
    """KT1's send i: two readings of each device, 1 s apart, device d at
    offset d mod 1000 ms, in timestamp order; 2 s of event time."""
    d = np.arange(KT1_KEYS, dtype=np.int64)
    base = 1000 + 2000 * i + d % 1000
    ts = np.concatenate([base, base + 1000])
    order = np.argsort(ts, kind="stable")
    dev = np.concatenate([d, d])[order]
    temp = (rng.integers(0, 1 << 14, 2 * KT1_KEYS) / 256).astype(np.float32)
    return [dev, (dev % 97).astype(np.int32), temp], ts[order]


class KT1Model:
    """KT1's slices in numpy: per device its start, pending slice (ts,
    temp) and previous slice's timestamps."""

    def __init__(self, np, K, t, C=KT1_C):
        self.np, self.t = np, t
        self.start = np.full(K, -1, np.int64)
        self.pts = np.zeros((K, C), np.int64)
        self.ptemp = np.zeros((K, C), np.float32)
        self.pn = np.zeros(K, np.int64)
        self.qts = np.zeros((K, C), np.int64)
        self.qn = np.zeros(K, np.int64)

    def _want(self, keys):
        """The rows of `keys`' flushes, key by key: the previous slice
        EXPIRED, then the pending slice CURRENT with its running max."""
        np = self.np
        C = self.pts.shape[1]
        ar = np.arange(C)[None, :]
        mask = np.concatenate([ar < self.qn[keys][:, None],
                               ar < self.pn[keys][:, None]], 1)
        kind = np.concatenate([np.ones((len(keys), C), np.int32),
                               np.zeros((len(keys), C), np.int32)], 1)
        ts = np.concatenate([self.qts[keys], self.pts[keys]], 1)
        mx = np.concatenate([np.zeros((len(keys), C), np.float32),
                             np.maximum.accumulate(self.ptemp[keys], 1)], 1)
        dev = np.repeat(np.asarray(keys, np.int64)[:, None], 2 * C, 1)
        return [x[mask] for x in (kind, ts, dev, mx)]

    def step(self, cols, ts, batches=None, what="KT1"):
        """Advances over one send: each device whose boundary the send's
        time has passed flushes in the timer tick at its boundary (one
        tick per distinct boundary, in order), then the arrivals join the
        pending slices.  With `batches` holds every tick's rows to the
        flushes (key by key; CURRENT rows with ts, deviceID and the running
        max; EXPIRED rows with ts) and the data step to no rows.  Returns
        the number of flushing devices."""
        np = self.np
        now = int(ts.max())
        bound = self.start + self.t
        due = (self.start >= 0) & (bound <= now)
        if batches is not None:
            steps = [b for b in batches if b["n_valid"]]
            ws = np.unique(bound[due])
            if len(steps) != ws.shape[0]:
                fail(f"{what}: {len(steps)} steps delivered rows, expected "
                     f"{ws.shape[0]} ticks")
            for b, w in zip(steps, ws):
                v = b["valid"]
                o_dev = b["cols"]["deviceID"][v]
                starts = np.r_[0, np.nonzero(o_dev[1:] != o_dev[:-1])[0] + 1]
                keys = o_dev[starts]
                if np.unique(keys).shape[0] != keys.shape[0] or \
                        not np.array_equal(np.sort(keys),
                                           np.nonzero(due & (bound == w))[0]):
                    fail(f"{what}: the tick at {w} flushed other devices, or "
                         f"a device's rows are not together")
                kind, wts, wdev, wmx = self._want(keys)
                cur = kind == 0
                got = b["cols"]["maxTemp"][v]
                if not (np.array_equal(b["kind"][v], kind) and
                        np.array_equal(b["ts"][v], wts) and
                        np.array_equal(o_dev, wdev) and
                        np.array_equal(b["cols"]["roomNo"][v],
                                       (wdev % 97).astype(np.int32)) and
                        np.array_equal(got[cur].view(np.int32),
                                       wmx[cur].view(np.int32))):
                    fail(f"{what}: the tick at {w} differs from the model")
        k = np.nonzero(due)[0]
        self.qts[k] = self.pts[k]
        self.qn[k] = self.pn[k]
        self.pn[k] = 0
        self.start[k] += self.t
        dev, _, temp = cols
        order = np.argsort(dev, kind="stable")
        d, t_s, tp = dev[order], ts[order], temp[order]
        head = np.ones(d.shape[0], np.bool_)
        head[1:] = d[1:] != d[:-1]
        first = np.nonzero(head)[0]
        a = np.arange(d.shape[0]) - first[np.cumsum(head) - 1]
        fresh = self.start[d[first]] < 0
        self.start[d[first][fresh]] = t_s[first][fresh]
        pos = self.pn[d] + a
        self.pts[d, pos] = t_s
        self.ptemp[d, pos] = tp
        np.add.at(self.pn, d, 1)
        return int(k.shape[0])


def pg1_send(np, rng, i):
    """PG1's send i: 131,072 readings over 1 s, device ids uniform over
    [16,384 i, 16,384 i + 2^20)."""
    ids = PG1_SHIFT * i + rng.integers(0, PG1_SPAN, PG1_B)
    ts = 1000 + 1000 * i + (np.arange(PG1_B, dtype=np.int64) * 1000) // PG1_B
    temp = (rng.integers(0, 1 << 14, PG1_B) / 256).astype(np.float32)
    return [ids.astype(np.int64), (ids % 97).astype(np.int32), temp], ts


class PG1Model:
    """PG1 in numpy: each device's running max(temp) and the time it was
    last seen; the purge tick every second (from the app's start at 0)
    forgets the devices last seen before the tick's time minus
    idle.period, so a purged device's maximum starts again."""

    def __init__(self, np, n_ids, idle, interval=1000):
        self.np, self.idle, self.interval = np, idle, interval
        self.maxv = np.full(n_ids, -np.inf, np.float32)
        self.last = np.full(n_ids, -1, np.int64)
        self.tick = interval

    def step(self, cols, ts, b=None, what="PG1"):
        """Advances over one send (the purge ticks up to its time, then
        its rows).  With `b`, the send's delivered rows, holds every row
        (in send order): deviceID, roomNo and the running max.  Returns
        the devices purged before the send."""
        np = self.np
        now = int(ts.max())
        purged = 0
        while self.tick <= now:
            gone = (self.last >= 0) & (self.last < self.tick - self.idle)
            self.maxv[gone] = -np.inf
            self.last[gone] = -1
            purged += int(gone.sum())
            self.tick += self.interval
        ids, room, temp = cols
        n = ids.shape[0]
        order = np.argsort(ids, kind="stable")
        k = ids[order]
        head = np.ones(n, np.bool_)
        head[1:] = k[1:] != k[:-1]
        seg = np.cumsum(head) - 1
        off = seg * 128.0              # temperatures lie in [0, 64)
        run = np.maximum.accumulate(temp[order] + off) - off
        run = np.maximum(run.astype(np.float32), self.maxv[k])
        want = np.empty(n, np.float32)
        want[order] = run
        last = np.r_[np.nonzero(head)[0][1:] - 1, n - 1]
        self.maxv[k[last]] = run[last]
        self.last[ids] = now
        if b is not None:
            v = b["valid"]
            got = (b["cols"]["deviceID"][v], b["cols"]["roomNo"][v],
                   b["cols"]["maxTemp"][v])
            if got[0].shape[0] != n or not (
                    np.array_equal(got[0], ids) and
                    np.array_equal(got[1], room) and
                    np.array_equal(got[2].view(np.int32),
                                   want.view(np.int32))):
                fail(f"{what}: rows differ from the model")
        return purged


def pf1_counts(np, sends, i):
    """PF1's (n_current, n_expired) at send i: the rows of send i with
    price > 0.5, and those of the send its 1-second window expires."""
    cur = int((sends[i][0][1] > 0.5).sum())
    old = i - FILL
    return cur, int((sends[old][0][1] > 0.5).sum()) if old >= 0 else 0


def pf1_check(np, sends, last, fetched, what="PF1"):
    """The last send's rows: count() of every symbol after the expiry
    (its last EXPIRED row) and after the send (its last CURRENT row)
    equals numpy's count of the window's rows with price > 0.5;
    avg(volume) is 1.0."""
    syms = [s[0][0] for s in sends]
    keep = [s[0][1] > 0.5 for s in sends]

    def win(lo, hi):
        return np.bincount(np.concatenate(
            [syms[j][keep[j]] for j in range(max(lo, 0), hi)]),
            minlength=PF1_SYM)
    (k_exp, c_exp), (k_cur, c_cur) = fetched
    if not (np.all(k_exp == 1) and np.all(k_cur == 0)):
        fail(f"{what}: the TIMER step must emit EXPIRED rows only and the "
             f"data step CURRENT rows only")
    for when, cols, want, pick, init in (
            ("after the send", c_cur, win(last - FILL + 1, last + 1),
             np.maximum, -1),
            ("after the expiry", c_exp, win(last - FILL + 1, last),
             np.minimum, 1 << 62)):
        got = np.full(PF1_SYM, init, np.int64)
        pick.at(got, cols["symbol"], cols["c"])
        seen = np.bincount(cols["symbol"], minlength=PF1_SYM) > 0
        if seen.sum() < PF1_SYM // 2 or \
                not np.array_equal(got[seen], want[seen]):
            fail(f"{what}: count per symbol {when} differs from numpy")
        if not np.all(cols["av"] == 1.0):
            fail(f"{what}: avg(volume) != 1.0")
        if np.any(cols["c"] < 1):
            fail(f"{what}: a delivered row counts no row")


def recorded(module, name, calls):
    """Wraps module.<name> so each call's arguments are appended to
    `calls`; returns the function that undoes it."""
    orig = getattr(module, name)

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    setattr(module, name, rec)
    return lambda: setattr(module, name, orig)


def compare_post_filter(torch, np, dev):
    """Phase 29a: K15 against its plain version on the rows of every step
    that reached it: PF1's time window at full batch (TIMER steps with
    131,072 EXPIRED rows, data steps with 131,072 CURRENT rows), a keyed
    timeBatch's flushes (EXPIRED, RESET and CURRENT rows), a post filter
    with `in Table`, bool and string columns and null operands, and every
    window kind at the top level.  Returns (max error, the timing inputs
    of a PF1 data step)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import post_filter as pf
    calls = []
    undo = recorded(pf, "launch", calls)
    rng = np.random.default_rng(91)
    try:
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(PF1_QL)
        h = rt.get_input_handler("S")
        for i in range(3):
            h.send_columns(config_rows(np, rng), timestamps=np.full(
                B1, 1000 + 500 * i, np.int64))
        rt.shutdown()
        n_pf1 = len(calls)
        for ql, sends in PF_CASES:
            rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
            rt.start()
            for sid, rows, ts in sends:
                rt.get_input_handler(sid).send(rows, timestamp=ts)
            rt.shutdown()
    finally:
        undo()
    err, n_rows, kinds = 0.0, 0, set()
    timing = None
    for j, ((spec, rows), _) in enumerate(calls):
        a = pf.launch(spec, rows)
        b = pf.plain(spec, rows, 0)
        torch.cuda.synchronize()
        err = max(err, float_err(torch, a, b, f"K15 step {j}"))
        n_rows += int(rows.ts.shape[0])
        kinds |= set(int(x) for x in torch.unique(rows.kind[rows.valid]))
        if j < n_pf1 and int((rows.valid & (rows.kind == 0)).sum()) == B1:
            timing = (spec, rows)
    if timing is None or not kinds >= {0, 1, 3}:
        fail(f"phase 29: K15 saw no PF1 data step or no EXPIRED / RESET "
             f"rows (kinds {sorted(kinds)})")
    print(f"compare: post_filter == plain over {len(calls)} steps "
          f"({n_rows} rows, kinds {sorted(kinds)}; {n_pf1} of PF1's)")
    return err, timing


def compare_keyed_tbatch(torch, np, dev):
    """Phase 29b: K11's timeBatch mode against its plain version at KT1's
    shape (65,536 keys x 128 rows), stage by stage (every row, [wake,
    missed] and the whole slab): data steps, a tick flushing the keys of
    one boundary, a tick that flushes every key across several collapsed
    boundaries, arrivals at or past the boundary of a step that does not
    flush, a key above its slice capacity (missed rows in both), padding
    key rows; then the time mode at RP1's shape (4 keys x 4,194,304 rows,
    3 range labels): in-order sends and ticks (the ordered prefix path),
    then a late reading in two areas; and at P2's shape (4,096 keys x
    256 rows), in-order sends, then a send with late trades (one key with
    more than its capacity) and ticks.  Returns (max error, timing
    inputs)."""
    from siddhi_tpu_torch.kernels import keyed_window as kw
    rng = np.random.default_rng(93)
    stats = {"steps": 0, "rows": 0, "pads": 0}
    err, timing = 0.0, {}
    kt = keyed_plan(dev, KT1_QL, "kt1")
    slab = kt.init_state()[0]
    slabs = [slab, slab.clone()]

    def twin(plan, args, what):
        nonlocal err
        e, rows = keyed_twin(torch, kw, plan, slabs, args, what, stats)
        err = max(err, e)
        return rows
    n_slice = KT1_T // 2000                 # sends a slice
    for i in range(min(3, n_slice - 1)):
        twin(kt, keyed_args(torch, np, dev, kt, *kt1_send(np, rng, i)),
             f"K11 timeBatch KT1 send {i}")
    for i in range(3, n_slice - 1):         # the rest of the first slice
        kw.launch(slabs[0], kt.filter_spec,
                  *keyed_args(torch, np, dev, kt, *kt1_send(np, rng, i)))
    slabs[1].copy_from(slabs[0])
    rows = twin(kt, keyed_args(torch, np, dev, kt, tick=1000 + KT1_T),
                "K11 timeBatch tick at one boundary")
    if not int((rows.kind == 3).sum()):
        fail("phase 29: the boundary tick flushed no key")
    cols, ts = kt1_send(np, rng, n_slice - 1)
    args = keyed_args(torch, np, dev, kt, cols, ts)
    timing["tbatch_data"] = (kt, slabs[0].clone(), args)
    twin(kt, args, f"K11 timeBatch KT1 send {n_slice - 1}")
    args = keyed_args(torch, np, dev, kt, tick=1000 + 3 * KT1_T + 999)
    timing["tbatch"] = (kt, slabs[0].clone(), args)
    rows = twin(kt, args, "K11 timeBatch tick flushing every key")
    n_reset = int((rows.kind == 3).sum())
    if n_reset != KT1_KEYS:
        fail(f"phase 29: the late tick flushed {n_reset} keys")
    # arrivals past the boundary of a step that does not flush (every
    # other reading 70 s later, the step's `now` the send's own time), and
    # a key above its slice capacity
    cols, ts = kt1_send(np, rng, 3 * n_slice + 5)
    late = ts.copy()
    late[::2] += KT1_T + 10_000
    args = list(keyed_args(torch, np, dev, kt, cols, late))
    args[7] = int(ts.max())
    twin(kt, tuple(args), "K11 timeBatch arrivals past the boundary")
    cols, ts = kt1_send(np, rng, 3 * n_slice + 6)
    reps = -(-3 * KT1_C // ts.shape[0])     # device 7: 3C readings
    cols, ts = [np.tile(c, reps) for c in cols], np.tile(ts, reps)
    cols[0][:3 * KT1_C] = 7
    _, wa = kw.launch(slabs[0].clone(), kt.filter_spec,
                      *keyed_args(torch, np, dev, kt, cols, ts))
    twin(kt, keyed_args(torch, np, dev, kt, cols, ts),
         "K11 timeBatch hot key")
    if int(wa[1]) <= 0:
        fail("phase 29: a key above its slice capacity reported no missed "
             "rows")
    del slabs, slab
    # -- the time mode at RP1's shape ------------------------------------
    rp = keyed_plan(dev, RP1_QL, "rp1")
    slab = rp.init_state()[0]
    slabs = [slab, slab.clone()]
    for i in range(3):
        cols, ts = rp1_send(np, rng, i)
        args = keyed_args(torch, np, dev, rp, cols, ts)
        if i == 2:
            timing["time_rp1"] = (rp, slabs[0].clone(), args)
        twin(rp, args, f"K11 time RP1 send {i}")
    # ticks expiring the first seconds, a send between them (RP1's
    # traffic is in order: the ordered path; phase 21's out-of-order P2
    # sends take the general one, which is quadratic in a key's rows)
    twin(rp, keyed_args(torch, np, dev, rp, tick=3000 + RP1_T),
         "K11 time RP1 tick")
    twin(rp, keyed_args(torch, np, dev, rp, *rp1_send(np, rng, 3)),
         "K11 time RP1 send 3")
    twin(rp, keyed_args(torch, np, dev, rp, tick=6000 + RP1_T),
         "K11 time RP1 tick after it")
    if int(slabs[0].key_state["ordered"][:3].sum()) != 3:
        fail("phase 29: RP1's in-order rings are not marked ordered")
    # a late reading in two areas, older than all their survivors (the
    # wake is the late row's), in-order readings in the third
    room = np.array([1100, 500] + [100] * 64, np.int32)
    ts = np.array([6500, 6500] + [60_000] * 64, np.int64)
    cols = [np.arange(room.shape[0], dtype=np.int64), room,
            rng.integers(0, 4, room.shape[0]).astype(np.float32)]
    _, wa = kw.launch(slabs[0].clone(), rp.filter_spec,
                      *keyed_args(torch, np, dev, rp, cols, ts))
    twin(rp, keyed_args(torch, np, dev, rp, cols, ts),
         "K11 time RP1 late readings")
    if int(wa[0]) != 6500 + RP1_T or \
            int(slabs[0].key_state["ordered"][:3].sum()) != 1:
        fail("phase 29: RP1's late readings did not set the wake and the "
             "order flags")
    del slabs, slab
    # -- the time mode at P2's shape: late arrivals after in-order rings ---
    p2 = keyed_plan(dev, P2_QL, "p2")
    slab = p2.init_state()[0]
    slabs = [slab, slab.clone()]
    for i in range(4):
        twin(p2, keyed_args(torch, np, dev, p2, *p2_send(np, rng, i)),
             f"K11 time P2 send {i}")
    # symbols 0-99 one trade each older than all their survivors, symbol
    # 100 more sorted trades than its 256 rows, all older than its
    # survivors (every survivor and its oldest trades drop, the ring ends
    # in order), the rest in order
    n_hot = 300
    sym = np.concatenate([np.arange(100), np.full(n_hot, 100),
                          np.arange(101, P2_SYMS)]).astype(np.int64)
    t3 = 1000 + 3 * P2_DT
    ts = np.concatenate([np.full(100, 900), 900 + np.arange(n_hot),
                         np.full(P2_SYMS - 101, t3 + 50)]).astype(np.int64)
    cols = [sym, rng.integers(1, 100, sym.shape[0]).astype(np.int64)]
    args = keyed_args(torch, np, dev, p2, cols, ts)
    _, wa = kw.launch(slabs[0].clone(), p2.filter_spec, *args)
    twin(p2, args, "K11 time P2 late")
    if int(wa[0]) != 1900:
        fail(f"phase 29: P2's late trades gave the wake {int(wa[0])}, not "
             "1900")
    ordered = slabs[0].key_state["ordered"]
    if int((ordered == 0).sum()) != 100:     # symbols 0-99, not 100
        fail("phase 29: P2's late trades did not set the order flags")
    for k, tk in enumerate((t3 + 800, t3 + 1200)):
        twin(p2, keyed_args(torch, np, dev, p2, tick=tk),
             f"K11 time P2 tick {k} after the late trades")
    del slabs, slab
    print(f"compare: keyed_window timeBatch and time modes == plain over "
          f"{stats['steps']} steps ({stats['rows']} rows, {stats['pads']} "
          f"padding key rows; every row, [wake, missed] and slab exact)")
    return err, timing


def k4_radix_case(torch, np, dev, rng, K, B, p_reset):
    """K4's radix mode against its plain version: random slots over K,
    CURRENT / EXPIRED / RESET / TIMER rows, rows without a slot."""
    from siddhi_tpu_torch.kernels import group_agg as ga
    specs = agg_specs(torch)
    kind = rng.choice([0, 1, 3, 2], B, p=[0.55 - p_reset, 0.35, p_reset, 0.1])
    kind_d = torch.from_numpy(kind.astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(B) < 0.95).to(dev)
    sign = ((valid & (kind_d == 0)).to(torch.int32) -
            (valid & (kind_d == 1)).to(torch.int32))
    gslot = torch.from_numpy(rng.integers(-1, K, B).astype(np.int32)).to(dev)
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
    return (specs, state, vals, sign, kind_d, valid, gslot)


def compare_group_agg_radix(torch, np, dev):
    """Phase 29c: K4's radix mode against its plain version on PG1's
    selector rows (2^21 slots; recorded from two sends through the
    runtime) and on random rows with RESET epochs at 8,192 and 2^21
    slots.  Returns (max error, the PG1 inputs)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import group_agg as ga
    rng = np.random.default_rng(95)
    calls = []
    undo = recorded(ga, "launch", calls)
    try:
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(PG1_QL)
        h = rt.get_input_handler("TempStream")
        for i in range(2):
            h.send_columns(*pg1_send(np, rng, i))
        rt.flush()
    finally:
        undo()
    cases = [("PG1 send", a[:7]) for a, _ in calls]
    if not cases or cases[-1][1][1][0].shape[0] != PG1_KEYS_CAP:
        fail("phase 29: PG1's selector did not reach group_agg at 2^21 "
             "slots")
    pg1_args = cases[-1][1]
    rt.shutdown()
    for K, B, p in ((8192, 2 * B1, 0.0005), (PG1_KEYS_CAP, 2 * B1, 0.001),
                    (PG1_KEYS_CAP, B1, 0.0)):
        cases.append((f"{K} slots, {B} rows, p(RESET) {p}",
                      k4_radix_case(torch, np, dev, rng, K, B, p)))
    err = 0.0
    before = ga.mode_launches[ga.MODE_RADIX]
    for what, args in cases:
        na, ra = ga.launch(*args)
        nb, rb = ga.plain(*args)
        torch.cuda.synchronize()
        for j in range(len(args[0])):
            err = max(err, float_err(torch, na[j], nb[j],
                                     f"K4 radix {what} state {j}"),
                      float_err(torch, ra[j], rb[j],
                                f"K4 radix {what} rows {j}"))
    if ga.mode_launches[ga.MODE_RADIX] - before != len(cases):
        fail("phase 29: a comparison did not take group_agg's radix mode")
    print(f"compare: group_agg radix mode == plain over {len(cases)} steps "
          f"(up to {PG1_KEYS_CAP} slots)")
    return err, pg1_args


def time_slice8_kernels(torch, np, dev, pf_in, kw_in, ga_in):
    """Phase 30: K15 at a PF1 data step, K11's timeBatch mode at a step
    that flushes every key and at a data step of KT1, its time mode at an
    RP1 data step, K4's radix mode at a PG1 send (CUDA-graph replays,
    the keyed slab restored before each), beside their plain versions and
    bounds."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.kernels import group_agg as ga
    from siddhi_tpu_torch.kernels import keyed_window as kw
    from siddhi_tpu_torch.kernels import post_filter as pf
    res = {}
    spec, rows = pf_in
    R = int(rows.ts.shape[0])
    lb, _ = code_bytes(spec.bytecode, rows.cols, [])
    res["post_filter"] = {
        "ms": graph_ms(torch, lambda: pf.launch(spec, rows), 20),
        "plain_ms": event_timer(torch, lambda: pf.plain(spec, rows, 0), 5),
        **bound(R * (4 + 1 + lb + 1), R * len(spec.bytecode)),
        "shape": f"{R} rows"}
    for mode in ("tbatch", "tbatch_data", "time_rp1"):
        planned, saved, args = kw_in[mode]
        slab = saved.clone()
        sp = planned.filter_spec

        def restore():
            slab.copy_from(saved)
        restore()
        n_out = int(kw.launch(slab, sp, *args)[0].ts.shape[0])
        nbytes = k11_bytes(torch, planned, saved, args, n_out)
        res[mode] = {
            "ms": graph_ms(torch, lambda: kw.launch(slab, sp, *args,
                                                    n_out=n_out), 10,
                           restore),
            "plain_ms": event_timer(torch, lambda: kw.plain(slab, sp, *args),
                                    2, restore),
            **bound(nbytes),
            "shape": f"{int(args[5].shape[0])} key rows, {n_out} rows out"}
        del slab
    _, state, vals, sign, kind, valid, gslot = ga_in
    B, K = sign.shape[0], state[0].shape[0]
    vb = sum(v.element_size() for v in vals)
    touched = int(torch.unique(
        torch.where(gslot >= 0, gslot, 0)[sign != 0]).shape[0])
    resets = int((valid & (kind == ev.RESET)).sum())
    state_bytes = (touched + K) * vb if resets else 2 * touched * vb
    res["group_agg_radix"] = {
        "ms": graph_ms(torch, lambda: ga.launch(*ga_in), 20),
        "plain_ms": event_timer(torch, lambda: ga.plain(*ga_in), 2),
        **bound(B * (4 + 4 + 1 + 4 + 2 * vb) + state_bytes),
        "shape": f"{B} rows, {touched} of {K} slots touched"}
    return res


def slice8_run(torch, np, rt, h, sends, model_step, check, mods, stream_fn,
               label):
    """Drives one configuration: sends[:fill] untimed, each `check`ed
    send held to the model, the timed sends between; returns (latencies,
    wall seconds of the timed sends, launches, plain calls).  `check` is
    (fill, n_check, checked before the timed sends)."""
    fill, n_check, early = check
    got = []
    rt.add_batch_callback(stream_fn, lambda ts, b: got.append(b))
    for m in mods.values():
        m.reset_counts()
    n_timed = len(sends) - fill - n_check
    t_lo = fill + (n_check if early else 0)
    lat, wall = [], 0.0
    for i, (cols, ts) in enumerate(sends):
        if i == t_lo:
            rt.flush()
            t0 = time.perf_counter()
        got.clear()
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if t_lo <= i < t_lo + n_timed:
            lat.append(time.perf_counter() - tb)
            if i == t_lo + n_timed - 1:
                rt.flush()
                wall = time.perf_counter() - t0
                # the model follows the timed sends outside the timing
                for j in range(t_lo, i + 1):
                    model_step(*sends[j], None, f"{label} send {j}")
            continue
        checked = (fill <= i < fill + n_check) if early else \
            (i >= t_lo + n_timed)
        model_step(cols, ts, list(got) if checked else None,
                   f"{label} send {i}")
    rt.flush()
    launches = {k: m.launches for k, m in mods.items()}
    plain = {k: m.plain_calls for k, m in mods.items()}
    return lat, wall, launches, plain


def run_rp1(torch, np, dev, mods):
    """RP1: the query guide's range-partition example at 10,000 devices,
    48 filling sends (the 10-minute windows fill: about 6M readings
    alive), 16 timed, 2 checked: every tick's and data step's rows held
    to RP1Model.  Returns K11's time-mode launches."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(RP1_QL)
    rt.start()
    h = rt.get_input_handler("TempStream")
    rng = np.random.default_rng(97)
    model = RP1Model(np, RP1_T)
    n = RP1_FILL + RP1_TIMED + RP1_CHECK
    sends = [rp1_send(np, rng, i) for i in range(n + 4)]
    ticks = []

    def step(cols, ts, b, what):
        ticks.append(model.step(cols, ts, b, what))
    lat, wall, launches, plain = slice8_run(
        torch, np, rt, h, sends[:n], step, (RP1_FILL, RP1_CHECK, False),
        mods, "rp1", "RP1")
    check_launched("RP1", launches, plain, ("keyed_window", "group_agg"))
    kw = mods["keyed_window"]
    slab, agg = rt.query_runtimes["rp1"].state
    alive = [int(x) for x in slab.count[:3].tolist()]
    full = RP1_T // 1000 * RP1_DEV          # a full 10-minute window
    if sum(alive) < 0.95 * full:
        fail(f"RP1: only {alive} readings alive of about {full}: the "
             f"windows are not full")
    mem = sum(x.numel() * x.element_size() for x in slab.tensors())
    print(f"RP1: {RP1_CHECK} sends after the timed ones held row by row to "
          f"the numpy model (every tick's EXPIRED rows with ts + 10 min and "
          f"the running avg, the data step's CURRENT rows, per area); "
          f"readings alive per label {alive}; ticks a send "
          f"{min(ticks[RP1_FILL:])}-{max(ticks[RP1_FILL:])}; device state "
          f"{mem} bytes (the [{slab.K}, {slab.C}] slab); K11 launches "
          f"{kw.launches} ({kw.tick_launches} ticks)")
    lat_line(np, "RP1 (range partition, time(10 min), 10,000 devices)", lat,
             wall, RP1_TIMED * RP1_B, RP1_B * (8 + 4 + 4 + 8 + 4 + 1 + 4))
    launches_main = kw.mode_launches[kw.MODE_TIME]
    host_profile(torch, np, rt, h, sends[n:], "RP1")
    mgr.shutdown()
    return launches_main


def run_kt1(torch, np, dev, mods):
    """KT1: per-device tumbling minute at 65,536 devices: 59 filling
    sends (one flush round at send 30), 2 checked (send 60 a flush round:
    every device flushes in the tick at its own boundary), 32 timed (one
    more round).  Returns K11's timeBatch launches."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(KT1_QL)
    rt.start()
    h = rt.get_input_handler("TempStream")
    rng = np.random.default_rng(99)
    model = KT1Model(np, KT1_KEYS, KT1_T)
    n = KT1_FILL + KT1_CHECK + KT1_TIMED
    sends = [kt1_send(np, rng, i) for i in range(n + 4)]
    flushes = []

    def step(cols, ts, b, what):
        flushes.append(model.step(cols, ts, b, what))
    lat, wall, launches, plain = slice8_run(
        torch, np, rt, h, sends[:n], step, (KT1_FILL, KT1_CHECK, True),
        mods, "kt1", "KT1")
    check_launched("KT1", launches, plain, ("keyed_window", "group_agg"))
    kw, ga = mods["keyed_window"], mods["group_agg"]
    checked = flushes[KT1_FILL:KT1_FILL + KT1_CHECK]
    if max(checked) != KT1_KEYS or sum(f == KT1_KEYS for f in flushes) < 3:
        fail(f"KT1: flush rounds {[i for i, f in enumerate(flushes) if f]}"
             f"; checked sends flushed {checked} devices")
    if ga.mode_launches[ga.MODE_RUNS] != ga.launches:
        fail("KT1: group_agg ran outside its run mode")
    slab = rt.query_runtimes["kt1"].state[0]
    mem = sum(x.numel() * x.element_size() for x in slab.tensors())
    print(f"KT1: sends {KT1_FILL}-{KT1_FILL + KT1_CHECK - 1} held row by row "
          f"to the numpy model (send {KT1_FILL + 1}: every device's flush "
          f"in the tick at its boundary, the previous slice EXPIRED, the "
          f"slice CURRENT with its running max); flush rounds at sends "
          f"{[i for i, f in enumerate(flushes) if f == KT1_KEYS]}; device "
          f"state {mem} bytes (the [{slab.K}, {slab.C}] slab pair); K11 "
          f"launches {kw.launches} ({kw.tick_launches} ticks)")
    lat_line(np, "KT1 (timeBatch(1 min) per device, 65,536 devices)", lat,
             wall, KT1_TIMED * 2 * KT1_KEYS,
             keyed_h2d(np, sends[0][0][0], KT1_KEYS, 8 + 4 + 4))
    launches_main = kw.mode_launches[kw.MODE_TBATCH]
    host_profile(torch, np, rt, h, sends[n:], "KT1")
    mgr.shutdown()
    return launches_main


def run_pg1(torch, np, dev, mods):
    """PG1: per-device running maximum without a window under @purge, 2^21
    group slots: 64 filling sends, 32 timed, 2 checked (every row against
    PG1Model, which forgets a device idle for 30 s); the allocator must
    hold fewer devices than it would without the purge.  Returns K4's
    radix launches."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(PG1_QL)
    rt.start()
    h = rt.get_input_handler("TempStream")
    rng = np.random.default_rng(101)
    n = PG1_FILL + PG1_TIMED + PG1_CHECK
    sends = [pg1_send(np, rng, i) for i in range(n + 4)]
    model = PG1Model(np, PG1_SHIFT * (n + 4) + PG1_SPAN, PG1_IDLE)
    purged = []

    def step(cols, ts, b, what):
        steps = None
        if b is not None:
            steps = [x for x in b if x["n_valid"]]
            if len(steps) != 1:
                fail(f"{what}: {len(steps)} steps delivered rows")
        purged.append(model.step(cols, ts, steps[0] if steps else None,
                                 what))
    lat, wall, launches, plain = slice8_run(
        torch, np, rt, h, sends[:n], step, (PG1_FILL, PG1_CHECK, False),
        mods, "pg1", "PG1")
    check_launched("PG1", launches, plain, ("filter_compact", "group_agg"))
    ga = mods["group_agg"]
    if ga.mode_launches[ga.MODE_RADIX] != ga.launches:
        fail("PG1: group_agg ran outside its radix mode")
    qr = rt.query_runtimes["pg1"]
    held = len(qr.planned.slot_allocator)
    seen = int((model.last >= 0).sum())
    distinct = PG1_SHIFT * (n - 1) + PG1_SPAN
    if held != seen:
        fail(f"PG1: the allocator holds {held} devices, the model {seen}")
    print(f"PG1: {PG1_CHECK} sends after the timed ones held row by row to "
          f"the numpy model (running max per device, reset when purged); "
          f"devices purged a tick {min(purged[40:] or [0])}-"
          f"{max(purged[40:] or [0])}; "
          f"the allocator holds {held} devices of about {distinct} ids drawn "
          f"(capacity {PG1_KEYS_CAP}); K4 radix launches {ga.mode_launches[ga.MODE_RADIX]}")
    lat_line(np, "PG1 (no window, @purge, 2^21 group slots)", lat, wall,
             PG1_TIMED * PG1_B, PG1_B * (8 + 4 + 4 + 8 + 4 + 1 + 4))
    launches_main = ga.mode_launches[ga.MODE_RADIX]
    host_profile(torch, np, rt, h, sends[n:], "PG1")
    mgr.shutdown()
    return launches_main


def run_pf1(torch, np, dev, mods):
    """PF1: config 1 with `[price > 0.5]` after its 1-second window: 104
    filling sends, 16 timed, 1 checked; every send's (n_current,
    n_expired) against numpy, the last send's counts per symbol.  Returns
    K15's launches."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(PF1_QL)
    rng = np.random.default_rng(103)
    sends = [(config_rows(np, rng), np.full(B1, 1000 + 10 * i, np.int64))
             for i in range(PF1_FILL + PF1_TIMED + 1)]
    last = len(sends) - 1
    fetch = []
    rt.add_batch_callback("q", lambda ts, b: fetch and fetch[-1].append(
        (b["kind"][b["valid"]], {k: v[b["valid"]] for k, v in
                                 b["cols"].items()})))
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "q", "S", sends, PF1_FILL, mods,
        last=lambda i: i == last and fetch.append([]), timed=PF1_TIMED)
    check_launched("PF1", launches, plain,
                   ("filter_compact", "time_window", "post_filter",
                    "group_agg"))
    for i, c in enumerate(counts):
        if c != pf1_counts(np, sends, i):
            fail(f"PF1 send {i}: (n_current, n_expired) {c}, numpy "
                 f"{pf1_counts(np, sends, i)}")
    pf1_check(np, sends, last, fetch[-1])
    fetch.clear()
    print(f"PF1: all {len(sends)} sends' (n_current, n_expired) equal "
          f"numpy's counts of price > 0.5 (steady {counts[-1]}); the last "
          f"send's count per symbol after the expiry and after the send "
          f"equal numpy's; launches {launches}")
    lat_line(np, "PF1 (config 1 with [price > 0.5] after the window)", lat,
             wall, PF1_TIMED * B1, B1 * (8 + 4 + 1 + 4 + 8 + 4 + 4))
    clock = [1000 + 10 * len(sends)]

    def send(_):
        rt.get_input_handler("S").send_columns(
            config_rows(np, rng), timestamps=np.full(B1, clock[0], np.int64))
        clock[0] += 10
    profile_line("PF1", 8, device_profile(torch, rt, 8, send))
    mgr.shutdown()
    return launches["post_filter"]


def slice8_phases(torch, np, dev):
    """Phases 29-32: K15, K11's timeBatch mode (and its time mode's
    ordered path) and K4's radix mode against their plain versions; their
    times; RP1, KT1, PG1 and PF1 through SiddhiManager.  Returns the K15,
    K11 timeBatch and K4 radix records."""
    mods = slice8_modules()
    err15, pf_in = compare_post_filter(torch, np, dev)
    err11, kw_in = compare_keyed_tbatch(torch, np, dev)
    torch.cuda.empty_cache()
    err4, ga_in = compare_group_agg_radix(torch, np, dev)
    res = time_slice8_kernels(torch, np, dev, pf_in, kw_in, ga_in)
    del pf_in, kw_in, ga_in
    torch.cuda.empty_cache()
    n_time = run_rp1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n_tb = run_kt1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n_radix = run_pg1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n_pf = run_pf1(torch, np, dev, mods)
    for name, t in (("keyed_window_tbatch (KT1 data step)",
                     res["tbatch_data"]),
                    ("keyed_window_time (RP1 data step)", res["time_rp1"])):
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} bytes), "
              f"plain {t['plain_ms']:.4f} ms; RP1's time-mode launches "
              f"{n_time}")
    records = []
    for name, key, src, rep, n, err, why in (
            ("post_filter", "post_filter", "post_filter.cu",
             "siddhi_tpu/core/planner.py:124", n_pf, err15,
             "no single PyTorch call evaluates a filter expression"),
            ("keyed_window_tbatch", "tbatch", "keyed_window.cu",
             "siddhi_tpu/core/window.py:573", n_tb, err11,
             "no single PyTorch call computes a per-key window step"),
            ("group_agg_radix", "group_agg_radix", "group_agg.cu",
             "siddhi_tpu/core/selector.py:320", n_radix, err4,
             "no single PyTorch call computes a segmented scan with carry "
             "state")):
        t = res[key]
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} bytes), "
              f"plain {t['plain_ms']:.4f} ms, launches on the main path {n}; "
              f"library_ms null: {why}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    return records


# RP1: the Siddhi 5.1 query guide's range-partition example (per-area
# average temperature) with the guide's TempStream
RP1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (roomNo >= 1030 as 'serverRoom' or
                roomNo < 1030 and roomNo >= 330 as 'officeRoom' or
                roomNo < 330 as 'lobby' of TempStream)
begin
  @capacity(keys='4', window='4194304')
  @info(name='rp1')
  from TempStream#window.time(10 min)
  select roomNo, deviceID, avg(temp) as avgTemp
  insert into AreaTempStream;
end;
"""
# KT1: P1's app with a per-device tumbling minute
KT1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (deviceID of TempStream)
begin
  @capacity(keys='65536')
  @info(name='kt1')
  from TempStream#window.timeBatch(1 min)
  select roomNo, deviceID, max(temp) as maxTemp
  insert into DeviceTempStream;
end;
"""
# PG1: P1's app without its window, with churning devices under @purge
PG1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (deviceID of TempStream)
begin
  @capacity(keys='2097152')
  @purge(enable='true', interval='1 sec', idle.period='30 sec')
  @info(name='pg1')
  from TempStream
  select roomNo, deviceID, max(temp) as maxTemp
  insert into DeviceTempStream;
end;
"""
# PF1: bench.py's config 1 with a filter after its window
PF1_QL = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(window='16777216')
@info(name='q') from S#window.time(1 sec)[price > 0.5]
select symbol, sum(price) as sp, count() as c, avg(volume) as av
group by symbol having sp > 0.0
insert into Out;
"""
# phase 29's other post filters: a keyed timeBatch (RESET rows), `in
# Table` with bool and string columns and nulls, every top-level window
_PF_DEF = """
@app:playback
define stream S (sym string, k long, v int, p float, b bool);
define stream W (sym string);
@PrimaryKey('sym') define table T (sym string);
from W select sym insert into T;
"""
PF_CASES = [
    (_PF_DEF + """
partition with (k of S)
begin
  @info(name='q') from S#window.timeBatch(100)[v > 1 or b]
  select k, sum(v) as sv insert all events into O;
end;""",
     [("S", [["a", k % 5, k % 4, 0.5 * k, k % 3 == 0] for k in range(40)],
       1000 + 30 * j) for j in range(8)]),
    (_PF_DEF + """
@info(name='q') from S#window.length(6)[sym in T and (p > 1.0 or v is null)]
select sym, count() as c insert all events into O;""",
     [("W", [["a"], ["c"]], 1000)] +
     [("S", [["abc"[k % 3], k, None if k % 5 == 0 else k, 0.25 * k,
              k % 2 == 0] for k in range(j, j + 9)], 1001 + j)
      for j in range(5)]),
] + [(_PF_DEF + f"""
@info(name='q') from S#window.{w}[v >= 2 and not b]
select k, sum(p) as sp insert all events into O;""",
      [("S", [["x", k % 3, k % 5, 0.5 * k, k % 4 == 0]
               for k in range(j, j + 7)], 1000 + 40 * j) for j in range(6)])
     for w in ("length(4)", "time(100)", "lengthBatch(3)", "timeBatch(90)")]


# ---------------------------------------------------------------------------
# slice 9: event-time, sort and session windows and distinctCount (phases
# 33-36): K16 ext_window, K17 sort_window, K12's external mode, K11's
# session mode and K4's refcount pass
# ---------------------------------------------------------------------------

EX_T0 = 1_760_000_000_000        # event times in epoch milliseconds
EX1_DEV, EX1_B, EX1_SPAN, EX1_JIT, EX1_T = 4096, 1 << 17, 4000, 2000, 60_000
EX1_C = 1 << 22
EX1_FILL, EX1_TIMED, EX1_CHECK = 16, 16, 2
XB1_B, XB1_SPAN, XB1_JIT, XB1_T = 1 << 17, 500, 100, 1000
XB1_FILL, XB1_TIMED, XB1_CHECK = 8, 16, 4
TL1_B, TL1_T, TL1_N, TL1_SYM = 1 << 17, 10_000, 1 << 20, 256
TL1_BURST, TL1_GAP = 16, 2000
DL1_B, DL1_T, DL1_STEP = 1 << 17, 1000, 250
DL1_FILL, DL1_TIMED, DL1_CHECK = 8, 16, 2
SO1_B, SO1_N = 1 << 17, 1000
SO1_FILL, SO1_TIMED, SO1_CHECK = 4, 16, 2
SE1_KEYS, SE1_C, SE1_B, SE1_GAP, SE1_STEP = 1 << 20, 256, 1 << 17, 5000, 250
SE1_ACTIVE, SE1_ROT = 1 << 14, 16     # active users: SE1_B / 8
SE1_FILL, SE1_CHECK, SE1_TIMED = 35, 2, 16
DC1_IPS, DC1_POOL, DC1_B, DC1_KEYS = 65536, 8, 1 << 17, 131072
DC1_FILL, DC1_TIMED, DC1_CHECK = 8, 16, 2

# EX1: the Siddhi 5.1 API reference's externalTime example (a sliding
# minute on the reading's own time), at 4,096 devices
EX1_QL = """
define stream SensorStream (deviceID long, eventTime long, temp double);
@capacity(window='4194304')
@info(name='ex1')
from SensorStream#window.externalTime(eventTime, 1 min)
select deviceID, avg(temp) as a, count() as n group by deviceID
insert all events into Out;
"""
XB1_QL = """
define stream SensorStream (deviceID long, eventTime long, temp double);
@capacity(window='1048576')
@info(name='xb1')
from SensorStream#window.externalTimeBatch(eventTime, 1 sec)
select deviceID, avg(temp) as a group by deviceID
insert all events into Out;
"""
TL1_QL = """
@app:playback
define stream TradeStream (symbol long, price double, volume int);
@info(name='tl1')
from TradeStream#window.timeLength(10 sec, 1048576)
select symbol, count() as c group by symbol
insert all events into Out;
"""
DL1_QL = """
@app:playback
define stream TradeStream (symbol long, price double, volume int);
@capacity(window='1048576')
@info(name='dl1')
from TradeStream#window.delay(1 sec)
select symbol, price insert into Out;
"""
SO1_QL = """
define stream TradeStream (symbol long, price double, volume int);
@info(name='so1')
from TradeStream#window.sort(1000, price, 'desc')
select symbol, price insert all events into Out;
"""
# SE1: the clickstream session; no `group by user`: a top-level query has
# 4,096 group slots in both packages and SE1's 2^20 users would exhaust
# them (the reference raises too), so the aggregates run over every live
# session
SE1_QL = """
@app:playback
define stream ClickStream (user long, page int, dwell double);
@capacity(keys='1048576', window='256')
@info(name='se1')
from ClickStream#window.session(5 sec, user)
select user, dwell, count() as clicks, sum(dwell) as d
insert all events into Out;
"""
# SE1's clicks through session(gap) at the top level: one session, K11's
# session mode on one key row
SE1_ONE_QL = """
@app:playback
define stream ClickStream (user long, page int, dwell double);
@capacity(window='262144')
@info(name='se1') from ClickStream#window.session(5 sec)
select user, dwell, count() as clicks, sum(dwell) as d
insert all events into Out;
"""
DC1_QL = """
define stream LoginStream (ip long, user long);
partition with (ip of LoginStream)
begin
  @capacity(keys='131072')
  @info(name='dc1')
  from LoginStream select ip, distinctCount(user) as users insert into Out;
end;
"""


def slice9_modules():
    from siddhi_tpu_torch.kernels import (ext_window, filter_compact,
                                          group_agg, keyed_window,
                                          sort_window, time_batch)
    return {"ext_window": ext_window, "sort_window": sort_window,
            "time_batch": time_batch, "keyed_window": keyed_window,
            "group_agg": group_agg, "filter_compact": filter_compact}


def ex1_send(np, rng, i, span=None, jit=None, b=None):
    """EX1's send i: readings i*B .. of 4,096 devices in turn, their
    arrival times spread over the send's `span` ms of event time from
    EX_T0, each reading's event time jittered back by up to `jit` ms (out
    of order within and across sends); integer temperatures 0-3, so every
    sum is exact."""
    span = EX1_SPAN if span is None else span
    jit = EX1_JIT if jit is None else jit
    B = EX1_B if b is None else b
    j = i * B + np.arange(B, dtype=np.int64)
    base = EX_T0 + i * span + np.arange(B, dtype=np.int64) * span // B
    ets = base - rng.integers(0, jit, B) if jit else base.copy()
    temp = rng.integers(0, 4, B).astype(np.float32)
    return [j % EX1_DEV, ets, temp], base


def xb1_send(np, rng, i):
    return ex1_send(np, rng, i, XB1_SPAN, XB1_JIT, XB1_B)


def trade_send(np, rng, i, ts, b):
    """One send of `b` trades at one timestamp: symbols 0-255, uniform
    prices, volume 1."""
    return ([rng.integers(0, TL1_SYM, b).astype(np.int64),
             rng.random(b, dtype=np.float32), np.ones(b, np.int32)],
            np.full(b, ts, np.int64))


def tl1_time(i):
    """TL1's send times: a burst 250 ms apart, then sends 2 s apart."""
    if i < TL1_BURST:
        return 1000 + 250 * i
    return 1000 + 250 * (TL1_BURST - 1) + TL1_GAP * (i - TL1_BURST + 1)


def se1_send(np, rng, i):
    """SE1's send i (at 1000 + 250 i): 7/8 of the clicks from the active
    set of 16,384 users (the set changes every 16 sends), 1/8 from users
    uniform over 2^20; dwell 0, 0.5 or 1 s, so every sum is exact."""
    B = SE1_B
    n_act = B * 7 // 8
    r = i // SE1_ROT
    act = (r * SE1_ACTIVE * 7919 + rng.integers(0, SE1_ACTIVE, n_act)) \
        % SE1_KEYS
    user = np.concatenate([act, rng.integers(0, SE1_KEYS, B - n_act)])
    rng.shuffle(user)
    return ([user.astype(np.int64), rng.integers(0, 64, B).astype(np.int32),
             rng.integers(0, 3, B).astype(np.float32) * 0.5],
            np.full(B, 1000 + SE1_STEP * i, np.int64))


def dc1_send(np, rng, i):
    """DC1's send i: logins from 65,536 IPs, each IP's user drawn from its
    pool of 8."""
    ip = rng.integers(0, DC1_IPS, DC1_B).astype(np.int64)
    user = ip * DC1_POOL + rng.integers(0, DC1_POOL, DC1_B)
    return [ip, user], np.full(DC1_B, 1000 + 10 * i, np.int64)


def sent_rows(np, batches, names):
    """The valid rows of one send's delivered steps, in delivery order:
    (kind, ts, {column: values})."""
    kinds, ts = [], []
    cols = {n: [] for n in names}
    for b in batches:
        if not b["n_valid"]:
            continue
        v = b["valid"]
        kinds.append(b["kind"][v])
        ts.append(b["ts"][v])
        for n in names:
            cols[n].append(b["cols"][n][v])

    def cat(x, d):
        return np.concatenate(x) if x else np.zeros(0, d)
    return (cat(kinds, np.int32), cat(ts, np.int64),
            {n: cat(c, np.float64) for n, c in cols.items()})


def expect(np, what, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.float32 or want.dtype == np.float32:
        got = got.astype(np.float32).view(np.int32)
        want = want.astype(np.float32).view(np.int32)
    if got.shape != want.shape or not np.array_equal(got, want):
        if got.shape != want.shape:
            fail(f"{what}: {got.shape[0]} {name} values, expected "
                 f"{want.shape[0]}")
        bad = np.nonzero(got != want)[0][:4]
        fail(f"{what}: {name} differs at rows {bad.tolist()}: "
             f"{got[bad].tolist()} vs {want[bad].tolist()}")


def group_cumsum(np, g, v):
    """The running sum of v within each group g, in row order."""
    o = np.argsort(g, kind="stable")
    gs, vs = g[o], v[o]
    cs = np.cumsum(vs)
    start = np.r_[0, np.nonzero(gs[1:] != gs[:-1])[0] + 1] if gs.size \
        else np.zeros(0, np.int64)
    lens = np.diff(np.r_[start, gs.size])
    base = np.repeat(cs[start] - vs[start], lens)
    out = np.empty_like(cs)
    out[o] = cs - base
    return out


def running_avg(np, g, sign, val, cnt0, sum0):
    """Per row: the group's count and float32 avg after the row (sum /
    count, NaN at count 0), from the counts and sums before the rows."""
    c = cnt0[g] + group_cumsum(np, g, sign.astype(np.int64))
    s = sum0[g] + group_cumsum(np, g, sign * val.astype(np.float64))
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(c != 0, s.astype(np.float32) / c.astype(np.float32),
                     np.float32("nan")).astype(np.float32)
    return c, a


class EX1Model:
    """EX1's window in numpy: the alive readings in (event time, arrival)
    order, each device's count and exact temperature sum.  A checked step
    holds every row: the EXPIRED ones (ts = event time + t) and CURRENT
    ones (their arrival ts) in the order of their keys 2*(ets + t) and
    2*ets + 1, with each device's running avg and count."""

    def __init__(self, np, t):
        self.np, self.t = np, t
        z = np.zeros(0, np.int64)
        self.ets, self.dev, self.temp = z, z, np.zeros(0, np.float32)
        self.cnt = np.zeros(EX1_DEV, np.int64)
        self.sum = np.zeros(EX1_DEV, np.float64)

    def step(self, cols, ts, batches, what):
        np, t = self.np, self.t
        dev, ets, temp = cols
        thr = int(ets.max()) - t
        ndb = int(np.searchsorted(self.ets, thr, side="right"))
        due = ets <= thr
        if batches is not None:
            keys = np.concatenate([2 * (self.ets[:ndb] + t),
                                   2 * (ets[due] + t), 2 * ets + 1])
            o = np.argsort(keys, kind="stable")
            nd = ndb + int(due.sum())
            kind = np.r_[np.ones(nd, np.int32), np.zeros(ets.shape[0],
                                                         np.int32)][o]
            r_ts = np.concatenate([self.ets[:ndb] + t, ets[due] + t, ts])[o]
            r_dev = np.concatenate([self.dev[:ndb], dev[due], dev])[o]
            r_temp = np.concatenate([self.temp[:ndb], temp[due], temp])[o]
            sign = np.where(kind == 0, 1.0, -1.0)
            c, a = running_avg(np, r_dev, sign, r_temp, self.cnt, self.sum)
            g_kind, g_ts, g = sent_rows(np, batches, ("deviceID", "a", "n"))
            expect(np, what, "kind", g_kind, kind)
            expect(np, what, "ts", g_ts, r_ts)
            expect(np, what, "deviceID", g["deviceID"], r_dev)
            expect(np, what, "n", g["n"], c)
            expect(np, what, "avg", g["a"], a)
        gone = np.concatenate([self.dev[:ndb], dev[due]])
        gone_t = np.concatenate([self.temp[:ndb], temp[due]])
        np.add.at(self.cnt, dev, 1)
        np.add.at(self.sum, dev, temp.astype(np.float64))
        np.add.at(self.cnt, gone, -1)
        np.add.at(self.sum, gone, -gone_t.astype(np.float64))
        keep = ~due
        e = np.concatenate([self.ets[ndb:], ets[keep]])
        o = np.argsort(e, kind="stable")
        self.ets = e[o]
        self.dev = np.concatenate([self.dev[ndb:], dev[keep]])[o]
        self.temp = np.concatenate([self.temp[ndb:], temp[keep]])[o]
        if self.ets.shape[0] > EX1_C:
            fail(f"{what}: the model holds more rows than the window")
        return ndb + int(due.sum())


class XB1Model:
    """XB1's tumbling second of event time in numpy: the pending and the
    previous slice (device, arrival ts, temp) and the slice start.  A
    flush's rows: the previous slice EXPIRED (its avg falling from the
    slice's per-device totals), then the slice CURRENT from zero (the
    RESET row between them is not delivered)."""

    def __init__(self, np, t):
        self.np, self.t = np, t
        self.start = -1
        self.pend = [np.zeros(0, np.int64)] * 2 + [np.zeros(0, np.float32)]
        self.prev = list(self.pend)

    def step(self, cols, ts, batches, what):
        np, t = self.np, self.t
        dev, ets, temp = cols
        start = self.start if self.start >= 0 else int(ets.min())
        nflush = max(int(ets.max()) - start, 0) // t
        bnd = start + (nflush or 1) * t
        inn = ets < bnd
        cat = [np.concatenate([p, x[inn]]) for p, x in
               zip(self.pend, (dev, ts, temp))]
        if nflush:
            if batches is not None:
                q_dev, q_ts, q_temp = self.prev
                cnt0 = np.bincount(q_dev, minlength=EX1_DEV)
                sum0 = np.bincount(q_dev, weights=q_temp.astype(np.float64),
                                   minlength=EX1_DEV)
                zc, zs = np.zeros(EX1_DEV, np.int64), np.zeros(EX1_DEV)
                _, a_e = running_avg(np, q_dev, -np.ones(q_dev.shape[0]),
                                     q_temp, cnt0, sum0)
                _, a_c = running_avg(np, cat[0], np.ones(cat[0].shape[0]),
                                     cat[2], zc, zs)
                g_kind, g_ts, g = sent_rows(np, batches, ("deviceID", "a"))
                expect(np, what, "kind", g_kind,
                       np.r_[np.ones(q_dev.shape[0], np.int32),
                             np.zeros(cat[0].shape[0], np.int32)])
                expect(np, what, "ts", g_ts, np.r_[q_ts, cat[1]])
                expect(np, what, "deviceID", g["deviceID"],
                       np.r_[q_dev, cat[0]])
                expect(np, what, "avg", g["a"], np.r_[a_e, a_c])
            self.prev = cat
            self.pend = [x[~inn] for x in (dev, ts, temp)]
            self.start = start + nflush * t
        else:
            if batches is not None and sum(b["n_valid"] for b in batches):
                fail(f"{what}: a step that does not flush delivered rows")
            self.pend = cat
            self.start = start
        return cat[0].shape[0] if nflush else 0


class TL1Model:
    """TL1's window in numpy: the alive trades in arrival order (each
    send's rows share its ts) and each symbol's count.  Over one send the
    delivered rows are the time expiries up to the send's time (the timer
    ticks', in expiry order, ts = expiry), the length evictions
    (EXPIRED, the evicting trade's ts, the evicted trade's symbol), then
    the send's trades CURRENT: every key of an eviction (4*ts + 1) sorts
    before every CURRENT key (4*ts + 2) of the same ts."""

    def __init__(self, np, t, n):
        self.np, self.t, self.n = np, t, n
        self.ts = np.zeros(0, np.int64)
        self.sym = np.zeros(0, np.int64)
        self.cnt = np.zeros(TL1_SYM, np.int64)

    def step(self, cols, ts, batches, what):
        np = self.np
        sym, now = cols[0], int(ts[0])
        nd = int(np.searchsorted(self.ts + self.t, now, side="right"))
        ev_n = max(self.ts.shape[0] - nd + sym.shape[0] - self.n, 0)
        e_sym = np.concatenate([self.sym[nd:], sym])[:ev_n]
        if batches is not None:
            k = np.r_[np.ones(nd + ev_n, np.int32),
                      np.zeros(sym.shape[0], np.int32)]
            r_ts = np.r_[self.ts[:nd] + self.t, np.full(ev_n + sym.shape[0],
                                                        now)]
            r_sym = np.r_[self.sym[:nd], e_sym, sym]
            sign = np.where(k == 0, 1, -1)
            c = self.cnt[r_sym] + group_cumsum(np, r_sym, sign)
            g_kind, g_ts, g = sent_rows(np, batches, ("symbol", "c"))
            expect(np, what, "kind", g_kind, k)
            expect(np, what, "ts", g_ts, r_ts)
            expect(np, what, "symbol", g["symbol"], r_sym)
            expect(np, what, "c", g["c"], c)
        np.add.at(self.cnt, self.sym[:nd], -1)
        np.add.at(self.cnt, e_sym, -1)
        np.add.at(self.cnt, sym, 1)
        self.ts = np.r_[self.ts[nd:], np.full(sym.shape[0], now)][ev_n:]
        self.sym = np.r_[self.sym[nd:], sym][ev_n:]
        return nd, ev_n


class DL1Model:
    """DL1's held trades in numpy (arrival order; a send's rows share its
    ts): over one send, every held trade whose ts + t has come is released
    CURRENT with its own ts, in release order."""

    def __init__(self, np, t):
        self.np, self.t = np, t
        self.rows = [np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.float32)]

    def step(self, cols, ts, batches, what):
        np = self.np
        now = int(ts[0])
        r_ts, r_sym, r_p = self.rows
        k = int(np.searchsorted(r_ts + self.t, now, side="right"))
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches, ("symbol", "price"))
            expect(np, what, "kind", g_kind, np.zeros(k, np.int32))
            expect(np, what, "ts", g_ts, r_ts[:k])
            expect(np, what, "symbol", g["symbol"], r_sym[:k])
            expect(np, what, "price", g["price"], r_p[:k])
        self.rows = [np.r_[x[k:], y] for x, y in
                     zip(self.rows, (ts, cols[0], cols[1]))]
        return k


class SO1Model:
    """SO1's standing top 1,000 in numpy (buffer in candidate order):
    every trade CURRENT in send order, then the evicted rows EXPIRED in
    candidate order (the kept rows are the 1,000 greatest prices, ties to
    the earlier candidate)."""

    def __init__(self, np, n):
        self.np, self.n = np, n
        self.rows = [np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.float32)]

    def step(self, cols, ts, batches, what):
        np = self.np
        c = [np.r_[x, y] for x, y in zip(self.rows, (ts, cols[0], cols[1]))]
        key = (-c[2]).astype(np.float64)
        rank = np.empty(key.shape[0], np.int64)
        rank[np.argsort(key, kind="stable")] = np.arange(key.shape[0])
        keep = rank < min(key.shape[0], self.n)
        ev = ~keep
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches, ("symbol", "price"))
            expect(np, what, "kind", g_kind,
                   np.r_[np.zeros(ts.shape[0], np.int32),
                         np.ones(int(ev.sum()), np.int32)])
            expect(np, what, "ts", g_ts, np.r_[ts, c[0][ev]])
            expect(np, what, "symbol", g["symbol"], np.r_[cols[0], c[1][ev]])
            expect(np, what, "price", g["price"], np.r_[cols[1], c[2][ev]])
        self.rows = [x[keep] for x in c]
        return int(ev.sum())


class SE1Model:
    """SE1's live sessions in numpy: every live row (user, ts, dwell) in
    arrival order and each user's last click.  Over one send, every
    session whose user's last click is `gap` or more before the send's
    time expires (the timer ticks' rows), then the send's clicks arrive.
    Rows come out key-major, so a checked send holds: the EXPIRED rows,
    each user's together and in ts order (ties in arrival order), equal
    to the expiring sessions' rows; the CURRENT rows, each user's
    together and in send order, equal to the send's clicks; and the
    global running count and dwell sum after each delivered row, from the
    totals before the send."""

    def __init__(self, np, gap):
        self.np, self.gap = np, gap
        self.user = np.zeros(0, np.int64)
        self.ts = np.zeros(0, np.int64)
        self.dwell = np.zeros(0, np.float32)
        self.last = np.full(SE1_KEYS, -1, np.int64)

    def _held(self, what, name, u, ts, dw, w_u, w_ts, w_dw):
        """Rows (u, ts, dw) delivered key-major against the expected ones
        (w_*) in per-user order: each user's rows together, and equal
        user by user."""
        np = self.np
        starts = np.r_[True, u[1:] != u[:-1]] if u.size else \
            np.zeros(0, np.bool_)
        if np.unique(u[starts]).shape[0] != int(starts.sum()):
            fail(f"{what}: a user's {name} rows are not together")
        o, wo = np.argsort(u, kind="stable"), np.argsort(w_u, kind="stable")
        expect(np, what, f"{name} user", u[o], w_u[wo])
        expect(np, what, f"{name} ts", ts[o], w_ts[wo])
        expect(np, what, f"{name} dwell", dw[o], w_dw[wo])

    def step(self, cols, ts, batches, what):
        np = self.np
        user, _, dwell = cols
        now = int(ts[0])
        exp_u = (self.last >= 0) & (self.last + self.gap <= now)
        gone = exp_u[self.user]
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches,
                                        ("user", "dwell", "clicks", "d"))
            ne = int(gone.sum())
            expect(np, what, "kind", g_kind,
                   np.r_[np.ones(ne, np.int32),
                         np.zeros(user.shape[0], np.int32)])
            gu = g["user"].astype(np.int64)
            gd = g["dwell"].astype(np.float32)
            # the model's expiring rows, per user in ts order (ties in
            # arrival order)
            o = np.lexsort((self.ts[gone], self.user[gone]))
            self._held(what, "expired", gu[:ne], g_ts[:ne], gd[:ne],
                       self.user[gone][o], self.ts[gone][o],
                       self.dwell[gone][o])
            if np.any((g_ts[1:ne] < g_ts[:ne - 1]) &
                      (gu[1:ne] == gu[:ne - 1])):
                fail(f"{what}: a session's rows are not in ts order")
            self._held(what, "current", gu[ne:], g_ts[ne:], gd[ne:], user,
                       ts, dwell)
            sign = np.where(g_kind == 0, 1, -1)
            expect(np, what, "clicks", g["clicks"],
                   self.user.shape[0] + np.cumsum(sign))
            expect(np, what, "d", g["d"].astype(np.float32),
                   (float(self.dwell.astype(np.float64).sum()) +
                    np.cumsum(sign * gd.astype(np.float64)))
                   .astype(np.float32))
        keep = ~gone
        self.user = np.r_[self.user[keep], user]
        self.ts = np.r_[self.ts[keep], ts]
        self.dwell = np.r_[self.dwell[keep], dwell]
        self.last[exp_u] = -1
        self.last[user] = now
        return int(exp_u.sum())


class DC1Model:
    """DC1's (IP, user) pairs seen, in numpy: each login's row holds its
    IP's distinct users after it (the rows come in send order)."""

    def __init__(self, np):
        self.np = np
        self.seen = np.zeros(DC1_IPS * DC1_POOL, np.bool_)
        self.cnt = np.zeros(DC1_IPS, np.int64)

    def step(self, cols, ts, batches, what):
        np = self.np
        ip, user = cols
        pair = user                      # ip * POOL + pool index
        _, first = np.unique(pair, return_index=True)
        new = np.zeros(pair.shape[0], np.bool_)
        new[first] = True
        new &= ~self.seen[pair]
        c = self.cnt[ip] + group_cumsum(np, ip, new.astype(np.int64))
        if batches is not None:
            g_kind, _, g = sent_rows(np, batches, ("ip", "users"))
            expect(np, what, "kind", g_kind, np.zeros(ip.shape[0], np.int32))
            expect(np, what, "ip", g["ip"], ip)
            expect(np, what, "users", g["users"], c)
        self.seen[pair] = True
        np.add.at(self.cnt, ip, new.astype(np.int64))
        return int(self.seen.sum())


# -- kernels against their plain versions -----------------------------------

def window_plan(dev, ql, qname):
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    return rt.query_runtimes[qname].planned


def window_args(torch, np, dev, planned, cols=None, ts=None, tick=None):
    """One send's arrivals as a top-level window step sees them (K1's
    compaction, without a counter: each arrival's seq is its input row),
    with its `now` and host facts; `tick` (a time): a TIMER step."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.window import BatchFacts
    from siddhi_tpu_torch.kernels import filter_compact as fc
    if tick is not None:
        staged = ev.pack_np(planned.in_schema, [], capacity=8)
        staged.ts[0], staged.kind[0], staged.valid[0] = tick, ev.TIMER, True
        now = tick
    else:
        staged = stage(np, ev, cols, ts)
        now = int(np.asarray(ts).max())
    gslot = planned.slot_allocator.slots_for(
        [staged.cols[i] for i in planned.group_by_positions],
        staged.valid) if planned.slot_allocator is not None else \
        np.zeros(staged.ts.shape[0], np.int32)
    b = staged.to_device(planned.in_schema, dev)
    arr, n = fc.launch(planned.filter_spec, b.ts, b.kind, b.valid,
                       torch.from_numpy(gslot).to(dev), b.cols, None)
    cur = np.logical_and(staged.valid, staged.kind == ev.CURRENT)
    return arr, n, now, BatchFacts(staged.ts[cur], staged.ts.shape[0],
                                   staged, cur)


def ext_state_err(torch, a, b, what):
    la, lb = a.alive(), b.alive()
    err = float_err(torch, a.meta, b.meta, f"{what} meta")
    for k in la:
        if k not in ("seq", "missed"):
            err = max(err, float_err(torch, la[k], lb[k], f"{what} {k}"))
    return err


def sort_state_err(torch, a, b, what):
    n = int(a.meta[0])
    err = float_err(torch, a.meta, b.meta, f"{what} meta")
    for x, y in zip(a.tensors()[:-1], b.tensors()[:-1]):
        err = max(err, float_err(torch, x[:n], y[:n], f"{what} buffer"))
    return err


def tb_state_err(torch, a, b, what):
    err = float_err(torch, a.meta, b.meta, f"{what} meta")
    for (sa, sb) in zip(a.slices(), b.slices()):
        for x, y in zip((sa[0], sa[1], *sa[2]), (sb[0], sb[1], *sb[2])):
            err = max(err, float_err(torch, x, y, f"{what} slice"))
    return err


class Twin:
    """A kernel's state and a clone for its plain version, stepped
    together: every emitted row, the wake and the whole state compared."""

    def __init__(self, torch, state, state_err):
        self.torch, self.s, self.err_fn = torch, [state, state.clone()], \
            state_err
        self.err, self.steps, self.rows = 0.0, 0, 0

    def step(self, launch, plain, what):
        torch = self.torch
        ra, rb = launch(self.s[0]), plain(self.s[1])
        torch.cuda.synchronize()
        if len(ra) == 2:                    # (rows, wake)
            (ra, wa), (rb, wb) = ra, rb
            self.err = max(self.err, float_err(torch, wa, wb, f"{what} wake"))
        self.err = max(self.err, rows_err(torch, ra, rb, what, full=True),
                       self.err_fn(torch, self.s[0], self.s[1], what))
        self.steps += 1
        self.rows += int(ra.ts.shape[0])
        return ra


def compare_ext(torch, np, dev):
    """Phase 33a: K16 against its plain version, step by step, at EX1's,
    TL1's and DL1's shapes: EX1's filling sends (out-of-order event times,
    epoch milliseconds, the window filling to about 1.97M rows), a send
    without arrivals, a small window that drops its oldest survivors;
    TL1's burst (the length evicting 131,072 rows a send) and
    its timer ticks; DL1's held trades and ticks.  A window of EX1_B / 2
    rows drops survivors.  Returns (max error, the
    timing inputs)."""
    from siddhi_tpu_torch.kernels import ext_window as ew
    rng = np.random.default_rng(111)
    out, timing = 0.0, {}
    plan = window_plan(dev, EX1_QL, "ex1")
    t = plan.window.time_ms
    tw = Twin(torch, plan.init_state()[0], ext_state_err)
    small = Twin(torch, ew.ExtState.empty(ew.MODE_EXT, plan.in_schema,
                                          EX1_B // 2, dev), ext_state_err)
    pos = plan.window.ts_pos
    for i in range(EX1_FILL + 1):
        arr, n, now, _ = window_args(torch, np, dev, plan,
                                     *ex1_send(np, rng, i))
        if i == EX1_FILL:
            timing["ext"] = (tw.s[0].clone(), arr, n, now, t, 0,
                             arr.cols[pos])
        tw.step(lambda s: ew.launch(s, arr, n, now, t, ets=arr.cols[pos]),
                lambda s: ew.plain(s, arr, n, now, t, ets=arr.cols[pos]),
                f"K16 externalTime EX1 send {i}")
        if i < 4:
            small.step(
                lambda s: ew.launch(s, arr, n, now, t, ets=arr.cols[pos]),
                lambda s: ew.plain(s, arr, n, now, t, ets=arr.cols[pos]),
                f"K16 externalTime {EX1_B // 2}-row window send {i}")
    arr, n, now, _ = window_args(torch, np, dev, plan, tick=now)
    tw.step(lambda s: ew.launch(s, arr, n, now, t, ets=arr.cols[pos]),
            lambda s: ew.plain(s, arr, n, now, t, ets=arr.cols[pos]),
            "K16 externalTime, no arrivals")
    alive = int(tw.s[0].meta[0])
    if alive < 0.9 * EX1_T // EX1_SPAN * EX1_B:
        fail(f"phase 33: EX1's window holds {alive} rows")
    if int(small.s[0].meta[2]) <= 0:
        fail("phase 33: the small window dropped no survivors")
    out = max(out, tw.err, small.err)
    print(f"phase 33a K16 externalTime: {tw.steps + small.steps} steps, "
          f"{tw.rows + small.rows} rows equal (window {alive} rows alive; "
          f"the small window dropped {int(small.s[0].meta[2])})")
    del tw, small
    # -- timeLength at TL1's shape -----------------------------------------
    plan = window_plan(dev, TL1_QL, "tl1")
    t, L = plan.window.time_ms, plan.window.length
    tw = Twin(torch, plan.init_state()[0], ext_state_err)
    last, ticks = 0, 0
    for i in range(TL1_BURST + 6):
        now = tl1_time(i)
        while True:                 # the timer ticks due by this send
            m = int(tw.s[0].meta[0])
            w = int(tw.s[0].key[:m].min()) if m else None
            if w is None or w > now:
                break
            ticks += 1
            arr, n, _, _ = window_args(torch, np, dev, plan, tick=w)
            if "tlen_tick" not in timing:
                timing["tlen_tick"] = (tw.s[0].clone(), arr, n, w, t, L,
                                       None)
            tw.step(lambda s: ew.launch(s, arr, n, w, t, L),
                    lambda s: ew.plain(s, arr, n, w, t, L),
                    f"K16 timeLength TL1 tick at {w}")
        arr, n, _, _ = window_args(torch, np, dev, plan,
                                   *trade_send(np, rng, i, now, TL1_B))
        if i == TL1_BURST - 1:
            timing["tlen"] = (tw.s[0].clone(), arr, n, now, t, L, None)
        tw.step(lambda s: ew.launch(s, arr, n, now, t, L),
                lambda s: ew.plain(s, arr, n, now, t, L),
                f"K16 timeLength TL1 send {i}")
        last = now
    out = max(out, tw.err)
    if not ticks:
        fail("phase 33: no timeLength tick expired rows")
    print(f"phase 33a K16 timeLength: {tw.steps} steps ({ticks} ticks), "
          f"{tw.rows} rows equal (window {int(tw.s[0].meta[0])} rows alive "
          f"at {last})")
    del tw
    # -- delay at DL1's shape ----------------------------------------------
    plan = window_plan(dev, DL1_QL, "dl1")
    t = plan.window.time_ms
    tw = Twin(torch, plan.init_state()[0], ext_state_err)
    for i in range(8):
        now = 1000 + DL1_STEP * i
        for w in (1000 + DL1_STEP * j + t for j in range(i)):
            if now - DL1_STEP < w <= now:
                arr, n, _, _ = window_args(torch, np, dev, plan, tick=w)
                if i == 7:
                    timing["delay"] = (tw.s[0].clone(), arr, n, w, t, 0,
                                       None)
                tw.step(lambda s: ew.launch(s, arr, n, w, t),
                        lambda s: ew.plain(s, arr, n, w, t),
                        f"K16 delay DL1 tick at {w}")
        arr, n, _, _ = window_args(torch, np, dev, plan,
                                   *trade_send(np, rng, i, now, DL1_B))
        tw.step(lambda s: ew.launch(s, arr, n, now, t),
                lambda s: ew.plain(s, arr, n, now, t),
                f"K16 delay DL1 send {i}")
    out = max(out, tw.err)
    print(f"phase 33a K16 delay: {tw.steps} steps, {tw.rows} rows equal "
          f"({int(tw.s[0].meta[0])} rows held)")
    return out, timing


def compare_sort(torch, np, dev):
    """Phase 33b: K17 against its plain version at SO1's shape (sort(1000,
    price, 'desc'), 131,072 trades a send), with a send whose prices hold
    NaN, +inf and -0.0 (ties with the dead candidates' +inf key), and an
    int-key asc window with LONG_MIN and BIG_SEQ keys and filtered-out
    rows between the arrivals.  Returns (max error, timing inputs)."""
    from siddhi_tpu_torch.kernels import sort_window as sw
    rng = np.random.default_rng(113)
    plan = window_plan(dev, SO1_QL, "so1")
    w = plan.window
    tw = Twin(torch, plan.init_state()[0], sort_state_err)
    timing = None
    for i in range(6):
        cols, ts = trade_send(np, rng, i, 1000 + i, SO1_B)
        if i == 4:
            cols[1][::7] = np.float32("nan")
            cols[1][1::11] = np.float32("inf")
            cols[1][2::13] = np.float32(-0.0)
        arr, n, _, facts = window_args(torch, np, dev, plan, cols, ts)
        B = facts.capacity
        if i == 3:
            timing = (tw.s[0].clone(), arr, n, w.length, w.key_pos,
                      w.descending, B)
        tw.step(lambda s: sw.launch(s, arr, n, w.length, w.key_pos,
                                    w.descending, B),
                lambda s: sw.plain(s, arr, n, w.length, w.key_pos,
                                   w.descending, B),
                f"K17 SO1 send {i}")
    ql = ("define stream S (k long, v int);\n@info(name='q') from "
          "S#window.sort(300, k)[v > 2] select k, v insert all events into O;")
    plan = window_plan(dev, ql, "q")
    w = plan.window
    tw2 = Twin(torch, plan.init_state()[0], sort_state_err)
    for i in range(5):
        k = rng.integers(-1000, 1000, 4096).astype(np.int64)
        k[::97] = -(2 ** 63)
        k[1::89] = (2 ** 63 - 1) // 4
        cols = [k, rng.integers(0, 6, 4096).astype(np.int32)]
        arr, n, _, facts = window_args(torch, np, dev, plan, cols,
                                       np.full(4096, 2000 + i, np.int64))
        tw2.step(lambda s: sw.launch(s, arr, n, w.length, w.key_pos,
                                     w.descending, facts.capacity),
                 lambda s: sw.plain(s, arr, n, w.length, w.key_pos,
                                    w.descending, facts.capacity),
                 f"K17 int asc send {i}")
    print(f"phase 33b K17: {tw.steps + tw2.steps} steps, "
          f"{tw.rows + tw2.rows} rows equal")
    return max(tw.err, tw2.err), timing


def compare_xbatch(torch, np, dev):
    """Phase 33c: K12's external mode against its plain version at XB1's
    shape: sends that flush every other send (about 262,144 rows) and
    that do not, event times jittered back, a send without arrivals.
    Returns (max error, timing inputs)."""
    from siddhi_tpu_torch.kernels import time_batch as tb
    rng = np.random.default_rng(117)
    plan = window_plan(dev, XB1_QL, "xb1")
    w = plan.window
    tw = Twin(torch, plan.init_state()[0], tb_state_err)
    timing, flushes = None, 0
    for i in range(9):
        if i == 8:
            arr, n, now, facts = window_args(torch, np, dev, plan, tick=now)
            cur = np.zeros(0, np.int64)
        else:
            arr, n, now, facts = window_args(torch, np, dev, plan,
                                             *xb1_send(np, rng, i))
            cur = facts.staged.cols[w.ts_pos][facts.cur]
        ets = arr.cols[w.ts_pos]
        cap = tb.out_capacity_ext(tw.s[0], cur, w.time_ms, True)
        if cap and timing is None and i > 2:
            timing = (tw.s[0].clone(), arr, n, now, w.time_ms, cap, ets)
        rows = tw.step(
            lambda s: tb.launch(s, arr, n, now, w.time_ms, cap, ets),
            lambda s: tb.plain(s, arr, n, now, w.time_ms, cap, ets),
            f"K12 external XB1 send {i}")
        flushes += int((rows.kind == 3).sum())
    if flushes < 3:
        fail(f"phase 33: XB1's sends flushed {flushes} times")
    print(f"phase 33c K12 external: {tw.steps} steps, {tw.rows} rows equal "
          f"({flushes} flushes)")
    return tw.err, timing


def compare_session(torch, np, dev):
    """Phase 33d: K11's session mode against its plain version at SE1's
    shape (2^20 keys x 256 rows): sends of active and one-click users, a
    timer tick over every key that expires the sessions gone quiet, a
    hot key above its capacity (missed rows in both), padding key rows;
    then session(gap) at the top level (one key row) over a send of
    131,072 clicks and the tick that expires them.  Returns (max error,
    timing inputs)."""
    from siddhi_tpu_torch.kernels import keyed_window as kw
    rng = np.random.default_rng(119)
    stats = {"steps": 0, "rows": 0, "pads": 0}
    plan = keyed_plan(dev, SE1_QL, "se1")
    torch.cuda.empty_cache()
    slab = plan.init_state()[0]
    slabs = [slab, slab.clone()]
    err, timing = 0.0, {}
    for i in range(3):
        args = keyed_args(torch, np, dev, plan, *se1_send(np, rng, i))
        if i == 2:
            timing["data"] = (plan, slabs[0].clone(), args)
        e, _ = keyed_twin(torch, kw, plan, slabs, args,
                          f"K11 session SE1 send {i}", stats)
        err = max(err, e)
    args = keyed_args(torch, np, dev, plan, tick=1000 + 2 * SE1_STEP +
                      SE1_GAP)
    timing["tick"] = (plan, slabs[0].clone(), args)
    e, rows = keyed_twin(torch, kw, plan, slabs, args,
                         "K11 session tick over every key", stats)
    err = max(err, e)
    if int(rows.ts.shape[0]) < SE1_B // 8:
        fail(f"phase 33: the tick expired {int(rows.ts.shape[0])} rows")
    # late joins over many keys: a send, then one whose clicks all lie
    # within the gap before it (late joins to the sessions it opened, new
    # sessions out of batch order), then the tick that expires them all
    # through the rank launch
    t_l = 1000 + 2 * SE1_STEP + 2 * SE1_GAP
    for what, late in (("before the late joins", 0),
                       ("late joins", 1)):
        cols, ts = se1_send(np, rng, 3)
        ts = np.full(ts.shape[0], t_l, np.int64)
        if late:
            ts -= rng.integers(1, SE1_GAP, ts.shape[0])
        e, _ = keyed_twin(torch, kw, plan, slabs,
                          keyed_args(torch, np, dev, plan, cols, ts),
                          f"K11 session SE1 {what}", stats)
        err = max(err, e)
    e, rows = keyed_twin(torch, kw, plan, slabs,
                         keyed_args(torch, np, dev, plan, tick=t_l + SE1_GAP),
                         "K11 session tick expiring the late sessions",
                         stats)
    err = max(err, e)
    n_late = int(rows.ts.shape[0])
    cols, ts = se1_send(np, rng, 30)
    cols[0][:2 * SE1_C] = 12345              # one user above 256 clicks
    args = keyed_args(torch, np, dev, plan, cols, ts)
    _, wa = kw.launch(slabs[0].clone(), plan.filter_spec, *args)
    e, _ = keyed_twin(torch, kw, plan, slabs, args, "K11 session hot key",
                      stats)
    if int(wa[1]) <= 0:
        fail("phase 33: a session above its capacity reported no missed "
             "rows")
    err = max(err, e)
    print(f"phase 33d K11 session: {stats['steps']} steps, {stats['rows']} "
          f"rows equal, {stats['pads']} padding key rows; the tick after "
          f"the late joins expired {n_late} rows")
    del slabs, slab
    # session(gap) at the top level: one key row, one thread over a whole
    # send, then a tick expiring the session (in ts order already)
    one = window_plan(dev, SE1_ONE_QL, "se1")
    slab = one.init_state()[0]
    slabs = [slab, slab.clone()]
    one_stats = {"steps": 0, "rows": 0, "pads": 0}
    cols, ts = se1_send(np, rng, 40)
    for key, args in (("one", one_key_args(torch, np, dev, one, cols, ts)),
                      ("one_tick", one_key_args(torch, np, dev, one,
                                                tick=int(ts[0]) + SE1_GAP))):
        timing[key] = (one, slabs[0].clone(), args)
        e, rows = keyed_twin(torch, kw, one, slabs, args,
                             f"K11 session, one key ({key})", one_stats)
        err = max(err, e)
    if int(rows.ts.shape[0]) != SE1_B:
        fail(f"phase 33: the one-key session expired {rows.ts.shape[0]} "
             f"rows")
    # a session with late joins: a send, then one whose clicks are half
    # late (older than the session's start, within the gap) and half on
    # time, then the tick that expires all 262,144 rows out of ts order
    # (the rank launch's path, the worst case of its quadratic count)
    cols, ts = se1_send(np, rng, 41)
    t0 = int(ts[0])
    e, _ = keyed_twin(torch, kw, one, slabs,
                      one_key_args(torch, np, dev, one, cols, ts),
                      "K11 session, one key, before the late joins",
                      one_stats)
    err = max(err, e)
    cols, ts = se1_send(np, rng, 42)
    late = rng.integers(1, SE1_GAP, ts.shape[0] // 2)
    ts[:late.shape[0]] = t0 - late
    e, _ = keyed_twin(torch, kw, one, slabs,
                      one_key_args(torch, np, dev, one, cols, ts),
                      "K11 session, one key, late joins", one_stats)
    err = max(err, e)
    args = one_key_args(torch, np, dev, one, tick=int(ts.max()) + SE1_GAP)
    timing["one_late_tick"] = (one, slabs[0].clone(), args)
    e, rows = keyed_twin(torch, kw, one, slabs, args,
                         "K11 session, one key, late session expired",
                         one_stats)
    err = max(err, e)
    r_ts = rows.ts.cpu().numpy()
    if r_ts.shape[0] != 2 * SE1_B or not np.all(np.diff(r_ts) >= 0):
        fail(f"phase 33: the late session expired {r_ts.shape[0]} rows, "
             f"not {2 * SE1_B} in ts order")
    print(f"phase 33d K11 session on one key: {one_stats['steps']} steps, "
          f"{one_stats['rows']} rows equal (a session of {2 * SE1_B} rows "
          f"with {late.shape[0]} late joins among them)")
    return err, timing


def one_key_args(torch, np, dev, planned, cols=None, ts=None, tick=None):
    """K11's arguments for a top-level session(gap) step: one key row
    whose events are the whole batch (`SessionWindow.process`)."""
    from siddhi_tpu_torch.core import event as ev
    if tick is not None:
        staged = ev.pack_np(planned.in_schema, [], capacity=8)
        staged.ts[0], staged.kind[0], staged.valid[0] = tick, ev.TIMER, True
        now = tick
    else:
        staged = stage(np, ev, cols, ts)
        now = int(np.asarray(ts).max())
    B = staged.ts.shape[0]
    b = staged.to_device(planned.in_schema, dev)
    return (b.ts, b.kind, b.valid, torch.zeros(B, dtype=torch.int32,
                                                device=dev), b.cols,
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.arange(B, dtype=torch.int32, device=dev).view(1, B), now,
            planned.window.gap_ms)


def compare_pairs(torch, np, dev):
    """Phase 33e: K4's refcount pass over pair slots (2^20 of them, radix
    mode) against its plain version at DC1's shape, and the distinct
    count's group pass it feeds, over three sends (pairs repeat).
    Returns (max error, timing inputs)."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.keyslots import SlotAllocator
    from siddhi_tpu_torch.kernels import group_agg as ga
    rng = np.random.default_rng(121)
    K = DC1_KEYS
    pairs, groups = SlotAllocator(8 * K), SlotAllocator(K)
    spec = [ga.ScanSpec(ga.OP_ADD, torch.int64, 0)]
    st = [torch.zeros(8 * K, dtype=torch.int64, device=dev)] * 2
    gst = [torch.zeros(K, dtype=torch.int64, device=dev)] * 2
    err, timing = 0.0, None
    B = DC1_B
    sign = torch.ones(B, dtype=torch.int32, device=dev)
    kind = torch.full((B,), ev.CURRENT, dtype=torch.int32, device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    ones = np.ones(B, np.bool_)
    for i in range(3):
        (ip, user), _ = dc1_send(np, rng, i)
        g = groups.slots_for([ip], ones)
        p = pairs.slots_for([g, user], ones)
        ps = torch.from_numpy(p).to(dev)
        vals = [sign.to(torch.int64)]
        if timing is None:
            timing = (spec, [st[0].clone()], vals, sign, kind, valid, ps)
        a = ga.launch(spec, [st[0]], vals, sign, kind, valid, ps, pair=True)
        b = ga.plain(spec, [st[1]], vals, sign, kind, valid, ps)
        torch.cuda.synchronize()
        err = max(err, float_err(torch, a[1][0], b[1][0], f"K4 pairs {i}"),
                  float_err(torch, a[0][0], b[0][0], f"K4 pairs {i} state"))
        st = [a[0][0], b[0][0]]
        dv = (a[1][0] == 1).to(torch.int64)
        gs = torch.from_numpy(g).to(dev)
        a2 = ga.launch(spec, [gst[0]], [dv], sign, kind, valid, gs)
        b2 = ga.plain(spec, [gst[1]], [dv], sign, kind, valid, gs)
        err = max(err, float_err(torch, a2[1][0], b2[1][0],
                                 f"K4 distinct {i}"))
        gst = [a2[0][0], b2[0][0]]
    print(f"phase 33e K4 refcount pass: 3 sends of {B} logins, "
          f"{len(pairs)} pair slots bound: equal")
    return err, timing


# -- timing -----------------------------------------------------------------

def row_bytes(rows):
    return 8 + 4 + 8 + 4 + sum(c.element_size() for c in rows.cols)


def k16_bytes(torch, saved, arr, na, now, t, ets, n_new, out):
    """(the bytes a K16 step needs, the bytes its design moves).  Needed:
    each arrival read, each buffer row that leaves (expires, is evicted or
    released) read, each output row written, each arrival the window keeps
    written; for externalTime also the buffer rows after the earliest kept
    arrival's event time, which an insertion in (ets, position) order
    moves (read and written).  The design reads every alive row and writes
    the whole new buffer instead."""
    n_in = int(saved.meta[0])
    rb = 8 + 8 + 4 + sum(c.element_size() for c in saved.cols)
    ab = 8 + 4 + sum(c.element_size() for c in arr.cols) + \
        (8 if ets is not None else 0)
    ob = row_bytes(out)
    n_out = int(out.ts.shape[0])
    if ets is not None:          # externalTime: its clock is ext_now
        a_key = ets[:na].to(torch.int64) + t
        clock = int(a_key.max()) - t if na else None
    else:                        # timeLength, delay: ts + t against now
        a_key, clock = arr.ts[:na] + t, now
    kept = a_key > clock if na else torch.zeros(0, dtype=torch.bool)
    e_in = min(int(kept.sum()), n_new)
    leave = max(n_in - (n_new - e_in), 0)
    tail = 0
    if ets is not None and e_in:
        first = int((a_key[kept] - t).min())
        b_key = saved.key[:n_in]
        tail = int(((b_key + t > clock) & (b_key > first)).sum())
    need = na * ab + leave * rb + n_out * ob + e_in * rb + 2 * tail * rb
    return need, n_in * rb + na * ab + n_out * ob + n_new * rb


def time_slice9(torch, np, dev, t_ext, t_sort, t_tb, t_ses, t_pair):
    """Phase 34: each kernel at its configuration's step (CUDA-graph
    replays; the state restored before each), its plain version and the
    bound of the bytes the step must move; K17 beside torch.topk of the
    same keys.  K16's bound counts what a window step needs, not its
    design's full rewrite of the buffer (`k16_bytes`)."""
    from siddhi_tpu_torch.kernels import ext_window as ew
    from siddhi_tpu_torch.kernels import group_agg as ga
    from siddhi_tpu_torch.kernels import keyed_window as kw
    from siddhi_tpu_torch.kernels import sort_window as sw
    from siddhi_tpu_torch.kernels import time_batch as tb
    res = {}
    for mode, key in (("ext", "ext_window_ext"), ("tlen", "ext_window_tlen"),
                      ("tlen_tick", "ext_window_tlen_tick"),
                      ("delay", "ext_window_delay")):
        saved, arr, n, now, t, L, ets = t_ext[mode]
        work = saved.clone()
        meta = saved.meta.clone()
        out = ew.launch(work, arr, n, now, t, L, ets)[0]
        n_out = int(out.ts.shape[0])
        need, rewrite = k16_bytes(torch, saved, arr, int(n), now, t, ets,
                                  int(work.meta[0]), out)

        def fixed():
            st = ew.ExtState(saved.mode, saved.ts, saved.key, saved.gslot,
                             saved.cols, meta)
            return ew.launch(st, arr, n, now, t, L, ets, n_out=n_out)
        res[key] = {
            "ms": graph_ms(torch, fixed, 10,
                           lambda: meta.copy_(saved.meta)),
            "plain_ms": event_timer(
                torch, lambda: ew.plain(work, arr, n, now, t, L, ets), 3,
                lambda: work.copy_from(saved)),
            **bound(need), "rewrite_bytes": rewrite,
            "shape": f"{int(saved.meta[0])} rows alive, {int(n)} arrivals, "
                     f"{n_out} rows out"}
    saved, arr, n, length, kp, desc, B = t_sort
    work = saved.clone()
    meta = saved.meta.clone()
    out = sw.launch(work, arr, n, length, kp, desc, B)
    n_out = int(out.ts.shape[0])
    n_in, na = int(saved.meta[0]), int(n)
    rb = 8 + 4 + sum(c.element_size() for c in saved.cols)

    def fixed_sort():
        st = sw.SortState(saved.ts, saved.gslot, saved.cols, meta)
        return sw.launch(st, arr, n, length, kp, desc, B, n_out=n_out)
    keys = -torch.cat([saved.cols[kp][:n_in], arr.cols[kp][:na]]).to(
        torch.float64)
    res["sort_window"] = {
        "ms": graph_ms(torch, fixed_sort, 10, lambda: meta.copy_(
            saved.meta)),
        "plain_ms": event_timer(
            torch, lambda: sw.plain(work, arr, n, length, kp, desc, B), 3,
            lambda: work.copy_from(saved)),
        "library_ms": event_timer(torch, lambda: torch.topk(keys, length,
                                                            largest=False),
                                  10),
        **bound((n_in + na) * rb + na * 8 + n_out * row_bytes(out) +
                int(work.meta[0]) * rb),
        "shape": f"{n_in} rows kept, {na} arrivals, {n_out} rows out"}
    saved, arr, n, now, t, cap, ets = t_tb
    work = saved.clone()

    def restore_tb():
        for a, b in zip(work_tensors(work), work_tensors(saved)):
            a.copy_(b)
    out = tb.launch(work, arr, n, now, t, cap, ets)[0]
    restore_tb()
    nv = int(out.valid.sum())
    pend, prev = (int(x) for x in saved.meta[2:4].tolist())
    rb = 8 + 4 + sum(c.element_size() for c in saved.b_cols[0])
    na = int(n)
    res["time_batch_ext"] = {
        "ms": graph_ms(torch, lambda: tb.launch(work, arr, n, now, t, cap,
                                                ets), 10, restore_tb),
        "plain_ms": event_timer(torch, lambda: tb.plain(work, arr, n, now, t,
                                                        cap, ets), 3,
                                restore_tb),
        **bound((pend + prev) * rb + na * (rb + 8) + nv * row_bytes(out) +
                na * rb),
        "shape": f"{pend} pending + {prev} previous rows, {na} arrivals, "
                 f"{nv} rows out"}
    for mode in ("tick", "data", "one", "one_tick", "one_late_tick"):
        planned, saved, args = t_ses[mode]
        slab = saved.clone()
        sp = planned.filter_spec

        def restore():
            slab.copy_from(saved)
        restore()
        n_out = int(kw.launch(slab, sp, *args)[0].ts.shape[0])
        nbytes = k11_bytes(torch, planned, saved, args, n_out)
        res[f"session_{mode}"] = {
            "ms": graph_ms(torch, lambda: kw.launch(slab, sp, *args,
                                                    n_out=n_out), 5,
                           restore),
            "plain_ms": event_timer(torch, lambda: kw.plain(slab, sp, *args),
                                    1, restore),
            **bound(nbytes),
            "shape": f"{int(args[5].shape[0])} key rows, {n_out} rows out"}
        del slab
    spec, st, vals, sign, kind, valid, ps = t_pair
    B, K = sign.shape[0], st[0].shape[0]
    touched = int(torch.unique(ps).shape[0])
    res["group_agg_pair"] = {
        "ms": graph_ms(torch, lambda: ga.launch(spec, st, vals, sign, kind,
                                                valid, ps, pair=True), 20),
        "plain_ms": event_timer(torch, lambda: ga.plain(spec, st, vals, sign,
                                                        kind, valid, ps), 2),
        **bound(B * (4 + 4 + 1 + 4 + 2 * 8) + 2 * touched * 8),
        "shape": f"{B} rows, {touched} of {K} pair slots touched"}
    return res


def work_tensors(st):
    return [*st.b_ts, *st.b_gslot, *(c for cols in st.b_cols for c in cols),
            st.meta]


# -- the configurations through SiddhiManager -------------------------------

def run9(torch, np, dev, mods, ql, qname, stream, sends, model, check,
         label, n_events, h2d, names):
    """One configuration through SiddhiManager: slice8_run's drive (the
    checked sends held to the model, the timed ones between), its latency
    line and a profiled sweep over 4 more sends.  Returns (each module's
    launches by mode and its timer-tick launches, its launches, the model
    results of every send), the counts taken when the main path's last
    send is done, before the sweep."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(ql)
    rt.start()
    h = rt.get_input_handler(stream)
    results = []

    def step(cols, ts, b, what):
        results.append(model.step(cols, ts, b, what))
    n = len(sends) - 4
    lat, wall, launches, plain = slice8_run(
        torch, np, rt, h, sends[:n], step, check, mods, qname, label)
    check_launched(label, launches, plain, names)
    counts = {k: (list(getattr(m, "mode_launches", ())),
                  getattr(m, "tick_launches", 0)) for k, m in mods.items()}
    lat_line(np, label, lat, wall, n_events, h2d)
    host_profile(torch, np, rt, h, sends[n:], label)
    mgr.shutdown()
    return counts, launches, results


def run_ex1(torch, np, dev, mods):
    """EX1: externalTime(eventTime, 1 min) at 4,096 devices, epoch-ms event
    times jittered back up to 2 s: 16 filling sends (about 1.97M rows
    alive), 16 timed, 2 checked row by row against EX1Model.  Returns
    K16's externalTime launches."""
    from siddhi_tpu_torch.kernels import ext_window as ew
    rng = np.random.default_rng(131)
    n = EX1_FILL + EX1_TIMED + EX1_CHECK
    sends = [ex1_send(np, rng, i) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, EX1_QL, "ex1", "SensorStream", sends,
        EX1Model(np, EX1_T), (EX1_FILL, EX1_CHECK, False),
        "EX1 (externalTime(1 min), 4,096 devices)", EX1_TIMED * EX1_B,
        EX1_B * (8 + 8 + 4 + 8 + 4 + 1 + 4),
        ("filter_compact", "ext_window", "group_agg"))
    k = counts["ext_window"][0][ew.MODE_EXT]
    print(f"EX1: sends {n - EX1_CHECK}-{n - 1} held row by row to the "
          f"numpy model (EXPIRED at event time + 1 min and CURRENT rows in "
          f"key order, each device's running avg and count); rows expiring "
          f"a steady send {res[-1]}; K16 externalTime launches {k}")
    return k


def run_xb1(torch, np, dev, mods):
    """XB1: externalTimeBatch(eventTime, 1 sec), 500 ms of event time a
    send: 8 filling, 4 checked (two flushes of about 262,144 rows), 16
    timed.  Returns K12's external launches."""
    tb = mods["time_batch"]
    rng = np.random.default_rng(133)
    n = XB1_FILL + XB1_CHECK + XB1_TIMED
    sends = [xb1_send(np, rng, i) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, XB1_QL, "xb1", "SensorStream", sends,
        XB1Model(np, XB1_T), (XB1_FILL, XB1_CHECK, True),
        "XB1 (externalTimeBatch(1 sec), 4,096 devices)", XB1_TIMED * XB1_B,
        XB1_B * (8 + 8 + 4 + 8 + 4 + 1 + 4),
        ("filter_compact", "time_batch", "group_agg"))
    flushed = [r for r in res if r]
    if len(flushed) < n // 3:
        fail(f"XB1: {len(flushed)} flushes over {n} sends")
    k = counts["time_batch"][0][tb.MODE_EXT]
    print(f"XB1: sends {XB1_FILL}-{XB1_FILL + XB1_CHECK - 1} held row by "
          f"row to the numpy model; rows a flush {min(flushed)}-"
          f"{max(flushed)}; K12 external launches {k}")
    return k


def run_tl1(torch, np, dev, mods):
    """TL1: timeLength(10 sec, 1048576) under playback: a burst of 16
    sends 250 ms apart (the length evicts 131,072 rows a send from the
    9th), then sends 2 s apart (the timer ticks expire each send of the
    burst 10 s on).  2 checked after the burst's 12 sends, 16 timed.
    Returns K16's timeLength launches."""
    from siddhi_tpu_torch.kernels import ext_window as ew
    rng = np.random.default_rng(137)
    n = 12 + 2 + 16
    sends = [trade_send(np, rng, i, tl1_time(i), TL1_B)
             for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, TL1_QL, "tl1", "TradeStream", sends,
        TL1Model(np, TL1_T, TL1_N), (12, 2, True),
        "TL1 (timeLength(10 sec, 1048576))", 16 * TL1_B,
        TL1_B * (8 + 4 + 4 + 8 + 4 + 1 + 4),
        ("filter_compact", "ext_window", "group_agg"))
    k = counts["ext_window"][0][ew.MODE_TLEN]
    ev_n = sum(e for _, e in res)
    tim = sum(t for t, _ in res)
    if not ev_n or not tim:
        fail(f"TL1: {ev_n} evictions, {tim} time expiries")
    print(f"TL1: sends 12-13 held row by row to the numpy model (time "
          f"expiries, evictions, CURRENT rows, each symbol's count); rows "
          f"evicted {ev_n}, expired by time {tim}; K16 timeLength launches "
          f"{k}")
    return k


def run_dl1(torch, np, dev, mods):
    """DL1: delay(1 sec) under playback, 131,072 trades a send 250 ms
    apart (about 600,000 held): 8 filling, 2 checked, 16 timed.  Returns
    K16's delay launches."""
    from siddhi_tpu_torch.kernels import ext_window as ew
    rng = np.random.default_rng(139)
    n = DL1_FILL + DL1_CHECK + DL1_TIMED
    sends = [trade_send(np, rng, i, 1000 + DL1_STEP * i, DL1_B)
             for i in range(n + 4)]
    counts, _, _ = run9(
        torch, np, dev, mods, DL1_QL, "dl1", "TradeStream", sends,
        DL1Model(np, DL1_T), (DL1_FILL, DL1_CHECK, True),
        "DL1 (delay(1 sec))", DL1_TIMED * DL1_B,
        DL1_B * (8 + 4 + 4 + 8 + 4 + 1 + 4), ("filter_compact", "ext_window"))
    k = counts["ext_window"][0][ew.MODE_DELAY]
    print(f"DL1: sends {DL1_FILL}-{DL1_FILL + DL1_CHECK - 1} held row by "
          f"row to the numpy model (released trades in release order); K16 "
          f"delay launches {k}")
    return k


def run_so1(torch, np, dev, mods):
    """SO1: a standing top 1,000 by price over 131,072 trades a send: 4
    filling, 2 checked, 16 timed.  Returns K17's launches."""
    rng = np.random.default_rng(141)
    n = SO1_FILL + SO1_CHECK + SO1_TIMED
    sends = [trade_send(np, rng, i, 1000 + i, SO1_B) for i in range(n + 4)]
    _, launches, res = run9(
        torch, np, dev, mods, SO1_QL, "so1", "TradeStream", sends,
        SO1Model(np, SO1_N), (SO1_FILL, SO1_CHECK, True),
        "SO1 (sort(1000, price, 'desc'))", SO1_TIMED * SO1_B,
        SO1_B * (8 + 4 + 4 + 8 + 4 + 1 + 4),
        ("filter_compact", "sort_window"))
    print(f"SO1: sends {SO1_FILL}-{SO1_FILL + SO1_CHECK - 1} held row by "
          f"row to the numpy model; rows evicted a send {min(res[2:])}-"
          f"{max(res[2:])}; K17 launches {launches['sort_window']}")
    return launches["sort_window"]


def run_se1(torch, np, dev, mods):
    """SE1: session(5 sec, user) at 2^20 keys x 256 rows, 131,072 clicks a
    send 250 ms apart under playback: 35 filling sends, 2 checked (send 35
    expires the first active set's sessions, about 1.8M rows), 16 timed.
    Returns K11's session launches (timer ticks included)."""
    kw = mods["keyed_window"]
    rng = np.random.default_rng(143)
    n = SE1_FILL + SE1_CHECK + SE1_TIMED
    sends = [se1_send(np, rng, i) for i in range(n + 4)]
    torch.cuda.empty_cache()
    counts, launches, res = run9(
        torch, np, dev, mods, SE1_QL, "se1", "ClickStream", sends,
        SE1Model(np, SE1_GAP), (SE1_FILL, SE1_CHECK, True),
        "SE1 (session(5 sec, user), 2^20 keys)", SE1_TIMED * SE1_B,
        keyed_h2d(np, sends[0][0][0], SE1_KEYS, 8 + 4 + 4),
        ("keyed_window", "group_agg"))
    modes, ticks = counts["keyed_window"]
    k = modes[kw.MODE_SESSION]
    print(f"SE1: sends {SE1_FILL}-{SE1_FILL + 1} held to the numpy model "
          f"(the expired sessions as a multiset, each session's rows "
          f"together in ts order, the clicks, the running totals); "
          f"sessions expiring a send {min(res[4:])}-{max(res[4:])} (send "
          f"{SE1_FILL}: {res[SE1_FILL]}); K11 session launches {k} "
          f"({ticks} ticks)")
    return k


def run_dc1(torch, np, dev, mods):
    """DC1: distinct users per source IP in a partition of 131,072 keys
    (2^20 pair slots): 8 filling, 16 timed, 2 checked against DC1Model.
    Returns K4's refcount-pass launches."""
    ga = mods["group_agg"]
    rng = np.random.default_rng(147)
    n = DC1_FILL + DC1_TIMED + DC1_CHECK
    sends = [dc1_send(np, rng, i) for i in range(n + 4)]
    counts, launches, res = run9(
        torch, np, dev, mods, DC1_QL, "dc1", "LoginStream", sends,
        DC1Model(np), (DC1_FILL, DC1_CHECK, False),
        "DC1 (distinctCount per IP, 2^20 pair slots)", DC1_TIMED * DC1_B,
        DC1_B * (8 + 8 + 8 + 4 + 1 + 4 + 4),
        ("filter_compact", "group_agg"))
    sent = np.unique(np.concatenate([c[1] for c, _ in sends[:n]])).shape[0]
    if res[-1] != sent or sent < 0.99 * DC1_IPS * DC1_POOL:
        fail(f"DC1: the model saw {res[-1]} distinct pairs, the sends hold "
             f"{sent} of {DC1_IPS * DC1_POOL}")
    modes = counts["group_agg"][0]
    print(f"DC1: sends {n - DC1_CHECK}-{n - 1} held row by row to the "
          f"numpy set model; distinct pairs {res[-1]} of "
          f"{DC1_IPS * DC1_POOL}; K4 launches by mode (sort, runs, radix, "
          f"refcount pass) {modes} of {launches['group_agg']}")
    return modes[ga.MODE_PAIR]


def slice9_phases(torch, np, dev):
    """Phases 33-36: K16's three modes, K17, K12's external mode, K11's
    session mode and K4's refcount pass against their plain versions;
    their times; EX1, XB1, TL1, DL1, SO1, SE1, DC1 and X2 through
    SiddhiManager.  Returns their kernel records."""
    mods = slice9_modules()
    e16, t_ext = compare_ext(torch, np, dev)
    torch.cuda.empty_cache()
    e17, t_sort = compare_sort(torch, np, dev)
    e12, t_tb = compare_xbatch(torch, np, dev)
    e11, t_ses = compare_session(torch, np, dev)
    torch.cuda.empty_cache()
    e4, t_pair = compare_pairs(torch, np, dev)
    res = time_slice9(torch, np, dev, t_ext, t_sort, t_tb, t_ses, t_pair)
    del t_ext, t_sort, t_tb, t_ses, t_pair
    torch.cuda.empty_cache()
    n = {"ext_window_ext": run_ex1(torch, np, dev, mods)}
    torch.cuda.empty_cache()
    n["time_batch_ext"] = run_xb1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n["ext_window_tlen"] = run_tl1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n["ext_window_delay"] = run_dl1(torch, np, dev, mods)
    n["sort_window"] = run_so1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n["keyed_window_session"] = run_se1(torch, np, dev, mods)
    torch.cuda.empty_cache()
    n["group_agg_pair"] = run_dc1(torch, np, dev, mods)
    run_corpus(torch, np, dev, mods, "X2", X9_CASES,
               ("ext_window", "sort_window", "time_batch", "keyed_window",
                "group_agg"))
    no_lib = "no single PyTorch call computes this window step"
    records = []
    for name, key, src, rep, err, lib in (
            ("ext_window_ext", "ext_window_ext", "ext_window.cu",
             "siddhi_tpu/core/window_ext.py:83", e16, no_lib),
            ("ext_window_tlen", "ext_window_tlen", "ext_window.cu",
             "siddhi_tpu/core/window_ext.py:279", e16, no_lib),
            ("ext_window_delay", "ext_window_delay", "ext_window.cu",
             "siddhi_tpu/core/window_ext.py:375", e16, no_lib),
            ("time_batch_ext", "time_batch_ext", "time_batch.cu",
             "siddhi_tpu/core/window_ext.py:178", e12, no_lib),
            ("sort_window", "sort_window", "sort_window.cu",
             "siddhi_tpu/core/window_ext.py:496", e17, None),
            ("keyed_window_session", "session_tick", "keyed_window.cu",
             "siddhi_tpu/core/window_ext.py:668", e11, no_lib),
            ("group_agg_pair", "group_agg_pair", "group_agg.cu",
             "siddhi_tpu/core/selector.py:294", e4,
             "no single PyTorch call computes a segmented scan with carry "
             "state")):
        t = res[key]
        lib_ms = t.get("library_ms")
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} bytes"
              f"{rewrite_note(t)}), plain {t['plain_ms']:.4f} ms, launches "
              f"on the main path {n[name]}; " +
              (f"library torch.topk {lib_ms:.4f} ms" if lib_ms is not None
               else f"library_ms null: {lib}"))
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n[name], "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": lib_ms})
    for key in ("ext_window_tlen_tick", "session_data", "session_one",
                "session_one_tick", "session_one_late_tick"):
        t = res[key]
        print(f"kernel {key}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}{rewrite_note(t)}), "
              f"plain {t['plain_ms']:.4f} ms")
    return records


def rewrite_note(t):
    """K16's own traffic beside its bound: the whole buffer read and
    rewritten."""
    if "rewrite_bytes" not in t:
        return ""
    b = t["rewrite_bytes"]
    return (f"; the design's full rewrite moves {b} bytes, "
            f"{b / H100_BYTES_PER_S * 1e3:.5f} ms at the memory rate")


# ---------------------------------------------------------------------------
# slice 10: batch, cron, hopping, frequent / lossyFrequent and session with
# allowed latency (K12's chunk and cron modes, K18 hop_window, K19
# frequent, K11's latency mode)
# ---------------------------------------------------------------------------

CB1_B, CB1_LEVELS = 1 << 17, 4096
CB1_FILL, CB1_CHECK, CB1_TIMED = 2, 2, 16
CR1_B, CR1_SYM, CR1_EVERY = 1 << 17, 4096, 5000
CR1_FILL, CR1_CHECK, CR1_TIMED = 10, 5, 16
HP1_B, HP1_SENSORS, HP1_WIN, HP1_HOP = 1 << 17, 10_000, 60_000, 10_000
HP1_FILL, HP1_CHECK, HP1_TIMED = 6, 2, 16
FQ1_B, FQ1_CARDS, FQ1_N = 1 << 17, 1 << 20, 1000
FQ1_FILL, FQ1_CHECK, FQ1_TIMED = 2, 2, 16
SL1_KEYS, SL1_ROWS, SL1_C = 1 << 20, 1 << 16, 128
SL1_GAP, SL1_LAT, SL1_STEP, SL1_LATE = 5000, 2000, 250, 7000
SL1_ACTIVE, SL1_ROT = 1 << 16, 12
SL1_FILL, SL1_CHECK, SL1_TIMED = 38, 2, 16

# CB1: prices of one chunk a send, by price level
CB1_QL = """
@app:playback
define stream PriceStream (level int, price float);
@info(name='cb1') from PriceStream#window.batch()
select level, count() as n, sum(price) as total group by level
insert all events into Out;
"""
# CR1: the Siddhi 5.1 API reference's cron example (sum(price) by symbol
# every 5 s), at 4,096 symbols under playback
CR1_QL = """
@app:playback
define stream StockStream (symbol long, price float);
@capacity(window='1048576')
@info(name='cr1') from StockStream#window.cron('*/5 * * * * ?')
select symbol, sum(price) as total group by symbol
insert all events into Out;
"""
# HP1: a trailing minute every 10 s over 10,000 sensors reporting once a
# second; the average is kept by zone (4 sensors a zone: a top-level query
# has 4,096 group slots in both packages)
HP1_QL = """
@app:playback
define stream SensorStream (sensor long, zone int, temp float);
@capacity(window='1048576')
@info(name='hp1') from SensorStream#window.hopping(1 min, 10 sec)
select zone, avg(temp) as a group by zone
insert all events into Out;
"""
# FQ1: the API reference's PotentialFraud query, at 1,000 counters
FQ1_QL = """
define stream purchase (cardNo long, price float);
@info(name='fq1')
from purchase[price >= 30]#window.lossyFrequent(0.001, 0.0001, cardNo)
select cardNo, price insert all events into PotentialFraud;
"""
# SL1: the API reference's session with late-arrival grace, at SE1's 2^20
# users
SL1_QL = """
@app:playback
define stream ClickStream (user long, page int, dwell float);
@capacity(keys='1048576', window='128')
@info(name='sl1') from ClickStream#window.session(5 sec, user, 2 sec)
select user, dwell, count() as clicks, sum(dwell) as d
insert all events into Out;
"""


def slice10_modules():
    from siddhi_tpu_torch.kernels import (filter_compact, frequent,
                                          group_agg, hop_window,
                                          keyed_window, time_batch)
    return {"time_batch": time_batch, "hop_window": hop_window,
            "frequent": frequent, "keyed_window": keyed_window,
            "group_agg": group_agg, "filter_compact": filter_compact}


def cb1_send(np, rng, i, b=CB1_B, levels=CB1_LEVELS):
    """CB1's send i: one chunk of b prices over the levels, each price a
    multiple of 0.5 below 4 (every sum exact)."""
    return ([rng.integers(0, levels, b).astype(np.int32),
             rng.integers(0, 8, b).astype(np.float32) * 0.5],
            np.full(b, 1000 + 100 * i, np.int64))


def cr1_send(np, rng, i, b=CR1_B, syms=CR1_SYM):
    """CR1's send i: b trades over 1 s of event time from EX_T0 (a
    multiple of 5 s), prices multiples of 0.5 below 4."""
    return ([rng.integers(0, syms, b).astype(np.int64),
             rng.integers(0, 8, b).astype(np.float32) * 0.5],
            EX_T0 + 1000 * i + np.arange(b, dtype=np.int64) * 1000 // b)


def hp1_send(np, rng, i, b=HP1_B, sensors=HP1_SENSORS):
    """HP1's send i: readings i*b .. of `sensors` sensors reporting once a
    second (reading j: sensor j % sensors at EX_T0 + 1 s * (j //
    sensors)), integer temperatures 0-3."""
    j = i * b + np.arange(b, dtype=np.int64)
    s = j % sensors
    return ([s, (s // 4).astype(np.int32),
             rng.integers(0, 4, b).astype(np.float32)],
            EX_T0 + 1000 * (j // sensors))


def fq1_send(np, rng, i, b=FQ1_B, cards=FQ1_CARDS):
    """FQ1's send i: b purchases, card numbers Zipf(1.1) over `cards`
    (scrambled), prices 0-59 (about half pass price >= 30)."""
    z = (rng.zipf(1.1, b) - 1) % cards
    return ([(z * 7919 + 13) % cards, rng.integers(0, 60, b)
             .astype(np.float32)], np.full(b, 1000 + i, np.int64))


def sl1_send(np, rng, i, rows=SL1_ROWS, keys=SL1_KEYS, active=SL1_ACTIVE):
    """SL1's send i (at 10,000 + 250 i): two clicks from each of `rows`
    users of the active group, each click late by 0-7 s (in 250 ms steps)
    with probability 0.1; dwell 0, 0.5 or 1 s.  Three groups of `active`
    users take turns of SL1_ROT sends (3 s), so a user comes back 6.25 s
    after its last click: its session has rotated to previous (after the
    5 s gap) and lingers (2 s of latency), and a click late by 5-7 s
    joins it or merges it."""
    g = (i // SL1_ROT) % 3
    u = (g * active * 7919 + rng.permutation(active)[:rows]) % keys
    user = np.repeat(u, 2)
    rng.shuffle(user)
    n = user.shape[0]
    now = 10_000 + SL1_STEP * i
    ts = np.full(n, now, np.int64)
    late = rng.random(n) < 0.1
    # late by whole sends: every ts on the 250 ms grid, so the sessions'
    # wakes (last + gap, end + gap + latency) fall on it too and the
    # runtime ticks at most a few times a send
    ts[late] -= SL1_STEP * rng.integers(0, SL1_LATE // SL1_STEP + 1,
                                        int(late.sum()))
    return ([user.astype(np.int64), rng.integers(0, 64, n).astype(np.int32),
             rng.integers(0, 3, n).astype(np.float32) * 0.5], ts)


def _sum_or_null(np, what, name, n, got, want):
    """A sum column: equal where the group's count is not 0, null (NaN)
    where it is."""
    z = np.asarray(n) == 0
    if not np.all(np.isnan(np.asarray(got)[z])):
        fail(f"{what}: {name} is not null at a count of 0")
    expect(np, what, name, np.asarray(got)[~z],
           np.asarray(want).astype(np.float32)[~z])


class CB1Model:
    """CB1's chunks in numpy: a send's rows are the previous chunk EXPIRED
    (each level's count and sum falling from the chunk's totals), then
    the send's chunk CURRENT from zero (the RESET row between them is not
    delivered)."""

    def __init__(self, np, levels=CB1_LEVELS):
        self.np, self.levels = np, levels
        z = np.zeros(0, np.int64)
        self.prev = (z.astype(np.int32), z, np.zeros(0, np.float32))

    def step(self, cols, ts, batches, what):
        np = self.np
        level, price = cols
        if batches is not None:
            q_l, q_ts, q_p = self.prev
            L = self.levels
            c0 = np.bincount(q_l, minlength=L)
            s0 = np.bincount(q_l, weights=q_p.astype(np.float64),
                             minlength=L)
            one = np.ones(q_l.shape[0])
            n_e = c0[q_l] - group_cumsum(np, q_l, one)
            s_e = s0[q_l] - group_cumsum(np, q_l, q_p.astype(np.float64))
            n_c = group_cumsum(np, level, np.ones(level.shape[0]))
            s_c = group_cumsum(np, level, price.astype(np.float64))
            g_kind, g_ts, g = sent_rows(np, batches, ("level", "n", "total"))
            expect(np, what, "kind", g_kind,
                   np.r_[np.ones(q_l.shape[0], np.int32),
                         np.zeros(level.shape[0], np.int32)])
            expect(np, what, "ts", g_ts, np.r_[q_ts, ts])
            expect(np, what, "level", g["level"].astype(np.int64),
                   np.r_[q_l, level].astype(np.int64))
            n = np.r_[n_e, n_c].astype(np.int64)
            expect(np, what, "n", g["n"].astype(np.int64), n)
            _sum_or_null(np, what, "total", n, g["total"], np.r_[s_e, s_c])
        self.prev = (level, ts, price)
        return int(level.shape[0])


class CR1Model:
    """CR1's cron batches in numpy: fires at the multiples of 5 s (a
    time zone's offset is a whole number of minutes), each one before the
    first send whose time reaches it.  A fire's rows: the previous batch
    EXPIRED (each symbol's sum falling from the batch's totals), then the
    pending rows CURRENT from zero; the sends' own steps emit nothing."""

    def __init__(self, np, syms=CR1_SYM, every=CR1_EVERY):
        self.np, self.syms, self.every = np, syms, every
        z = np.zeros(0, np.int64)
        self.pend = [z, z, np.zeros(0, np.float32)]
        self.prev = list(self.pend)
        self.next = None

    def step(self, cols, ts, batches, what):
        np = self.np
        now = int(ts.max())
        fired = 0
        rows = []
        while self.next is not None and self.next <= now:
            rows.append((self.prev, self.pend))
            self.prev = self.pend
            self.pend = [x[:0] for x in self.pend]
            self.next += self.every
            fired += int(self.prev[0].shape[0])
        if batches is not None:
            w_kind, w_ts, w_sym, w_tot = [], [], [], []
            for (q_s, q_ts, q_p), (p_s, p_ts, p_p) in rows:
                c0 = np.bincount(q_s, minlength=self.syms)
                s0 = np.bincount(q_s, weights=q_p.astype(np.float64),
                                 minlength=self.syms)
                n_e = c0[q_s] - group_cumsum(np, q_s, np.ones(q_s.shape[0]))
                s_e = s0[q_s] - group_cumsum(np, q_s, q_p.astype(np.float64))
                s_c = group_cumsum(np, p_s, p_p.astype(np.float64))
                w_kind += [np.ones(q_s.shape[0], np.int32),
                           np.zeros(p_s.shape[0], np.int32)]
                w_ts += [q_ts, p_ts]
                w_sym += [q_s, p_s]
                w_tot += [np.where(n_e == 0, np.nan, s_e), s_c]
            g_kind, g_ts, g = sent_rows(np, batches, ("symbol", "total"))

            def cat(x, d):
                return np.concatenate(x).astype(d) if x else np.zeros(0, d)
            expect(np, what, "kind", g_kind, cat(w_kind, np.int32))
            expect(np, what, "ts", g_ts, cat(w_ts, np.int64))
            expect(np, what, "symbol", g["symbol"].astype(np.int64),
                   cat(w_sym, np.int64))
            w = cat(w_tot, np.float64)
            _sum_or_null(np, what, "total", np.where(np.isnan(w), 0, 1),
                         g["total"], np.nan_to_num(w))
        self.pend = [np.r_[p, x] for p, x in zip(self.pend,
                                                 (cols[0], ts, cols[1]))]
        self.next = (now // self.every + 1) * self.every
        return fired


class HP1Model:
    """HP1's hopping window in numpy: the retained rows in candidate order
    (the buffer's, then each send's) and the next boundary.  Before a
    send, the timer fires at each boundary its time reaches (a TIMER step:
    the buffer's rows alone); a step whose time reaches the boundary
    flushes once, at the latest boundary it passed: the rows in [emit -
    hop - win, emit - hop) EXPIRED (each zone's avg falling from the
    aggregates the last flush left), then the rows in [emit - win, emit)
    CURRENT from zero."""

    def __init__(self, np, win=HP1_WIN, hop=HP1_HOP, zones=HP1_SENSORS // 4):
        self.np, self.win, self.hop, self.zones = np, win, hop, zones
        z = np.zeros(0, np.int64)
        self.buf = [z, z.astype(np.int32), z, np.zeros(0, np.float32)]
        self.next = -1
        self.cnt = np.zeros(zones, np.int64)
        self.sum = np.zeros(zones)

    def _step(self, now, arrivals, want):
        """One window step at `now` (arrivals: sensor, zone, ts, temp);
        appends the rows it emits to `want`; returns the CURRENT rows."""
        np = self.np
        win, hop = self.win, self.hop
        c = [np.r_[b, x] for b, x in zip(self.buf, arrivals)]
        nxt = self.next if self.next >= 0 else (
            int(arrivals[2].min()) + hop if arrivals[2].size else -1)
        emitted = 0
        if nxt >= 0 and now >= nxt:
            emit = nxt + ((now - nxt) // hop) * hop
            c_ts = c[2]
            d = (c_ts >= emit - hop - win) & (c_ts < emit - hop)
            k = (c_ts >= emit - win) & (c_ts < emit)
            zd, zc = c[1][d].astype(np.int64), c[1][k].astype(np.int64)
            _, a_e = running_avg(np, zd, -np.ones(zd.shape[0]), c[3][d],
                                 self.cnt, self.sum)
            zeros = np.zeros(self.zones, np.int64)
            _, a_c = running_avg(np, zc, np.ones(zc.shape[0]), c[3][k],
                                 zeros, zeros.astype(np.float64))
            want.append((np.r_[np.ones(zd.shape[0], np.int32),
                               np.zeros(zc.shape[0], np.int32)],
                         np.r_[c_ts[d], c_ts[k]], np.r_[zd, zc],
                         np.r_[a_e, a_c]))
            self.cnt = np.bincount(zc, minlength=self.zones)
            self.sum = np.bincount(zc, weights=c[3][k].astype(np.float64),
                                   minlength=self.zones)
            nxt = emit + hop
            emitted = int(k.sum())
        if nxt >= 0:
            c = [x[c[2] >= nxt - win - hop] for x in c]
        self.buf, self.next = c, nxt
        return emitted

    def step(self, cols, ts, batches, what):
        np = self.np
        now = int(ts.max())
        want, emitted = [], 0
        none = [x[:0] for x in self.buf]
        while 0 <= self.next <= now:            # the timer's hops
            emitted += self._step(self.next, none, want)
        emitted += self._step(now, (cols[0], cols[1], ts, cols[2]), want)
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches, ("zone", "a"))

            def cat(i, d):
                return np.concatenate([w[i] for w in want]).astype(d) \
                    if want else np.zeros(0, d)
            expect(np, what, "kind", g_kind, cat(0, np.int32))
            expect(np, what, "ts", g_ts, cat(1, np.int64))
            expect(np, what, "zone", g["zone"].astype(np.int64),
                   cat(2, np.int64))
            expect(np, what, "avg", g["a"], cat(3, np.float32))
        return emitted


class FQ1Model:
    """FQ1's Misra-Gries counters in numpy: the purchases that pass the
    filter, in send order, through n counters (a hit counts up and
    replaces its stored purchase, which leaves EXPIRED; a free counter
    takes the card; a full miss counts every counter down and the ones at
    0 leave EXPIRED, in counter order; a hit or an insert passes the
    purchase CURRENT).  A checked send's rows equal the model's, row for
    row (an EXPIRED row carries the arriving purchase's ts)."""

    def __init__(self, np, n=FQ1_N):
        import heapq
        self.np, self.n, self.heapq = np, n, heapq
        self.counts = np.zeros(n, np.int64)
        self.card = np.zeros(n, np.int64)
        self.price = np.zeros(n, np.float32)
        self.slot = {}
        self.free = list(range(n))
        self.hits = self.misses = 0

    def step(self, cols, ts, batches, what):
        np, hq = self.np, self.heapq
        card, price = cols
        p = np.nonzero(price >= 30)[0]
        kind, o_ts, o_card, o_price = [], [], [], []
        counts = self.counts
        for i in p.tolist():
            k = int(card[i])
            j = self.slot.get(k)
            if j is not None:
                counts[j] += 1
                self.hits += 1
                kind.append(1)
                o_ts.append(ts[i])
                o_card.append(self.card[j])
                o_price.append(self.price[j])
            elif self.free:
                j = hq.heappop(self.free)
                counts[j] = 1
                self.card[j] = k
                self.slot[k] = j
            else:
                self.misses += 1
                counts -= 1
                for e in np.nonzero(counts == 0)[0].tolist():
                    kind.append(1)
                    o_ts.append(ts[i])
                    o_card.append(self.card[e])
                    o_price.append(self.price[e])
                    del self.slot[int(self.card[e])]
                    hq.heappush(self.free, e)
                continue
            self.price[j] = price[i]
            kind.append(0)
            o_ts.append(ts[i])
            o_card.append(k)
            o_price.append(price[i])
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches, ("cardNo", "price"))
            expect(np, what, "kind", g_kind, np.array(kind, np.int32))
            expect(np, what, "ts", g_ts, np.array(o_ts, np.int64))
            expect(np, what, "cardNo", g["cardNo"].astype(np.int64),
                   np.array(o_card, np.int64))
            expect(np, what, "price", g["price"],
                   np.array(o_price, np.float32))
        return len(kind)


class SL1Model:
    """SL1's sessions with allowed latency in numpy, over every user:
    each user's current and previous session (rows, start, last; the
    previous one's alive time end + gap + latency).  Before a send, the
    timer ticks the runtime fires (at each least wake up to the send's
    time) expire previous sessions whose alive time has come and rotate
    current sessions whose gap has passed; then each user's clicks, in
    send order, join the current session, start a new one (the current
    one rotating, an older previous one expiring), join the previous one
    late (merging it into the current one when its end comes within two
    gaps of the current start) or are dropped.  A checked send holds: the
    EXPIRED rows the model expires (as a multiset of user, ts, dwell), the
    CURRENT rows the model keeps, and the global running count and dwell
    sum after each delivered row."""

    def __init__(self, np, keys=SL1_KEYS, gap=SL1_GAP, lat=SL1_LAT):
        self.np, self.gap, self.lat = np, gap, lat
        neg = np.full(keys, -1, np.int64)
        self.cs, self.cl, self.ps, self.pl, self.pa = (neg.copy()
                                                       for _ in range(5))
        # rows: user, ts, dwell, in the previous session, alive; the rows
        # of earlier sends in `r` (left dead until the send's end), the
        # send's own in `n`
        self.r = self._empty()
        self.n = self._empty()
        self.live_n, self.live_d = 0, 0.0
        self.stats = dict.fromkeys(("late_cur", "late_prev", "dropped",
                                    "merges", "rotations"), 0)

    def _empty(self):
        np = self.np
        return [np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32), np.zeros(0, np.bool_),
                np.zeros(0, np.bool_)]

    def _expire(self, users_mask, out):
        """The previous sessions of the users in the mask leave."""
        if not users_mask.any():
            return
        for u, t, d, p, a in (self.r, self.n):
            m = a & p & users_mask[u]
            out.append((u[m], t[m], d[m]))
            a[m] = False
        self.ps[users_mask] = self.pl[users_mask] = self.pa[users_mask] = -1

    def _rotate(self, users_mask):
        if not users_mask.any():
            return
        for r in (self.r, self.n):
            r[3] |= users_mask[r[0]]
        m = users_mask
        self.ps[m], self.pl[m] = self.cs[m], self.cl[m]
        self.pa[m] = self.cl[m] + self.gap + self.lat
        self.cs[m] = self.cl[m] = -1

    def _timeouts(self, now, users, out):
        """The batch-start timeouts at `now` of the users (a mask)."""
        pto = users & (self.pl >= 0) & (self.pa <= now)
        self._expire(pto, out)
        cto = users & (self.cl >= 0) & (self.cl + self.gap <= now)
        self._expire(cto & (self.pl >= 0), out)
        self._rotate(cto)
        self.stats["rotations"] += int(cto.sum())

    def _wake(self):
        np = self.np
        w = np.minimum(np.where(self.cl >= 0, self.cl + self.gap, BIG),
                       np.where(self.pl >= 0, self.pa, BIG))
        return int(w.min())

    def step(self, cols, ts, batches, what):
        np, gap = self.np, self.gap
        user, _, dwell = cols
        now = int(ts.max())
        out = []
        # the timer ticks: at each least wake up to the send's time
        everyone = np.ones(self.cs.shape[0], np.bool_)
        while True:
            w = self._wake()
            if w > now:
                break
            self._timeouts(w, everyone, out)
        # the data step: batch-start timeouts, then each user's clicks in
        # send order (the k-th click of every user at once)
        mask = np.zeros(self.cs.shape[0], np.bool_)
        mask[user] = True
        self._timeouts(now, mask, out)
        o = np.argsort(user, kind="stable")
        us = user[o]
        first = np.r_[True, us[1:] != us[:-1]]
        rank = np.arange(us.shape[0]) - np.maximum.accumulate(
            np.where(first, np.arange(us.shape[0]), 0))
        kept = np.zeros(user.shape[0], np.bool_)
        for e in range(int(rank.max()) + 1 if rank.size else 0):
            idx = o[rank == e]
            u, t, d = user[idx], ts[idx], dwell[idx]
            cs, cl, ps, pl = self.cs[u], self.cl[u], self.ps[u], self.pl[u]
            cur_has, prev_has = cl >= 0, pl >= 0
            new_sess = cur_has & (t >= cs) & (t > cl + gap)
            late_cur = cur_has & (t < cs) & (t >= cs - gap)
            late_prev = cur_has & (t < cs - gap) & prev_has & \
                (t >= ps - gap)
            k = ~cur_has | (cur_has & (t >= cs) & (t <= cl + gap)) | \
                new_sess | late_cur | late_prev
            rot = np.zeros(self.cs.shape[0], np.bool_)
            rot[u[new_sess]] = True
            self._expire(rot & (self.pl >= 0), out)
            self._rotate(rot)
            self.stats["rotations"] += int(new_sess.sum())
            to_cur = k & ~late_prev
            # appends: the click joins the user's session
            self.n = [np.r_[x, y] for x, y in zip(
                self.n, (u[k], t[k], d[k], late_prev[k],
                         np.ones(int(k.sum()), np.bool_)))]
            cs = np.where(new_sess | ~cur_has, t, np.minimum(cs, t))
            self.cs[u[to_cur]] = cs[to_cur]
            self.cl[u[to_cur]] = np.maximum(self.cl[u[to_cur]], t[to_cur])
            pu = u[late_prev]
            self.ps[pu] = np.minimum(self.ps[pu], t[late_prev])
            fwd = late_prev & (t > self.pl[u])
            self.pl[u[fwd]] = t[fwd]
            self.pa[u[fwd]] = t[fwd] + gap + self.lat
            can = (self.pl[u] >= 0) & (self.cl[u] >= 0) & \
                (self.pl[u] + gap >= self.cs[u] - gap)
            mg = (late_cur | fwd) & can
            mu = np.zeros(self.cs.shape[0], np.bool_)
            mu[u[mg]] = True
            if mg.any():
                for r in (self.r, self.n):
                    r[3] &= ~mu[r[0]]
            self.cs[mu] = np.minimum(self.cs[mu], self.ps[mu])
            self.cl[mu] = np.maximum(self.cl[mu], self.pl[mu])
            self.ps[mu] = self.pl[mu] = self.pa[mu] = -1
            kept[idx] = k
            for name, m in (("late_cur", late_cur), ("late_prev", late_prev),
                            ("dropped", ~k), ("merges", mg)):
                self.stats[name] += int(m.sum())
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches,
                                        ("user", "dwell", "clicks", "d"))
            e_u = np.concatenate([x[0] for x in out]) if out else \
                np.zeros(0, np.int64)
            e_t = np.concatenate([x[1] for x in out]) if out else \
                np.zeros(0, np.int64)
            e_d = np.concatenate([x[2] for x in out]) if out else \
                np.zeros(0, np.float32)
            gu, gd = g["user"].astype(np.int64), g["dwell"].astype(np.float32)
            for name, m, w in (
                    ("expired", g_kind == 1, (e_u, e_t, e_d)),
                    ("current", g_kind == 0, (user[kept], ts[kept],
                                              dwell[kept]))):
                a = np.lexsort((gd[m], g_ts[m], gu[m]))
                b = np.lexsort((w[2], w[1], w[0]))
                expect(np, what, f"{name} user", gu[m][a], w[0][b])
                expect(np, what, f"{name} ts", g_ts[m][a], w[1][b])
                expect(np, what, f"{name} dwell", gd[m][a], w[2][b])
            sign = np.where(g_kind == 0, 1, -1)
            expect(np, what, "clicks", g["clicks"],
                   self.live_n + np.cumsum(sign))
            expect(np, what, "d", g["d"].astype(np.float32),
                   (self.live_d + np.cumsum(sign * gd.astype(np.float64)))
                   .astype(np.float32))
        self.r = [np.r_[x[self.r[4]], y[self.n[4]]]
                  for x, y in zip(self.r, self.n)]
        self.n = self._empty()
        n_exp = sum(int(x[0].shape[0]) for x in out)
        self.live_n += int(kept.sum()) - n_exp
        self.live_d += float(dwell[kept].astype(np.float64).sum()) - sum(
            float(x[2].astype(np.float64).sum()) for x in out)
        return n_exp


BIG = 1 << 62


def small_drive(np, mgr, ql, qname, stream, sends, model, label):
    """A configuration at a small size through `mgr` (the CPU in the
    tests): every send's delivered rows held to the model.  Returns the
    model's results."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    rt.add_batch_callback(qname, lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler(stream)
    res = []
    for i, (cols, ts) in enumerate(sends):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        res.append(model.step(cols, ts, list(got), f"{label} send {i}"))
    mgr.shutdown()
    return res


def cb1_small_check(np, mgr):
    rng = np.random.default_rng(5)
    # chunks above the 512 rows the reference keeps: the buffer grows
    sends = [cb1_send(np, rng, i, 700, 64) for i in range(4)]
    res = small_drive(np, mgr, CB1_QL, "cb1", "PriceStream", sends,
                      CB1Model(np, 64), "CB1")
    return res == [700] * 4


def cr1_small_check(np, mgr):
    rng = np.random.default_rng(6)
    sends = [cr1_send(np, rng, i, 256, 16) for i in range(17)]
    m = CR1Model(np, 16)
    res = small_drive(np, mgr, CR1_QL, "cr1", "StockStream", sends, m,
                      "CR1")
    return [r for r in res if r] == [5 * 256] * 3


def hp1_small_check(np, mgr):
    rng = np.random.default_rng(7)
    sends = [hp1_send(np, rng, i, 2048, 200) for i in range(12)]
    m = HP1Model(np, zones=50)
    res = small_drive(np, mgr, HP1_QL, "hp1", "SensorStream", sends, m,
                      "HP1")
    return sum(1 for r in res if r) >= 8


def fq1_small_check(np, mgr):
    rng = np.random.default_rng(8)
    sends = [fq1_send(np, rng, i, 1024, 4096) for i in range(3)]
    ql = FQ1_QL.replace("0.001, 0.0001", "0.02, 0.001")
    m = FQ1Model(np, 50)
    small_drive(np, mgr, ql, "fq1", "purchase", sends, m, "FQ1")
    return m.hits > 0 and m.misses > 0


def sl1_small_check(np, mgr):
    rng = np.random.default_rng(9)
    sends = [sl1_send(np, rng, i, 32, 4096, 128) for i in range(44)]
    ql = SL1_QL.replace("1048576", "4096")
    m = SL1Model(np, 4096)
    small_drive(np, mgr, ql, "sl1", "ClickStream", sends, m, "SL1")
    return all(m.stats[k] > 0 for k in m.stats)


# -- the kernels against their plain versions --------------------------------

def hop_state_err(torch, a, b, what):
    err = float_err(torch, a.meta, b.meta, f"{what} meta")
    la, lb = a.alive(), b.alive()
    for k in la:
        if torch.is_tensor(la[k]):
            err = max(err, float_err(torch, la[k], lb[k], f"{what} {k}"))
    return err


def freq_state_err(torch, a, b, what):
    err = max(float_err(torch, a.counts, b.counts, f"{what} counts"),
              float_err(torch, a.meta, b.meta, f"{what} seq"))
    la, lb = a.alive(), b.alive()
    for k in la:
        if torch.is_tensor(la[k]):
            err = max(err, float_err(torch, la[k], lb[k], f"{what} {k}"))
    return err


def compare_chunk_cron(torch, np, dev):
    """Phase 37a: K12's chunk and cron modes against their plain versions:
    CB1's chunks (131,072 rows each, a TIMER step between that must keep
    the chunk), then CR1's pending sends and the fires that flush 655,360
    rows while the fire step's own arrivals start the next batch.  Returns
    (max error, timing inputs)."""
    from siddhi_tpu_torch.kernels import time_batch as tb
    rng = np.random.default_rng(151)
    timing = {}
    plan = window_plan(dev, CB1_QL, "cb1")
    st = plan.init_state()[0]
    st.grow(CB1_B)
    tw = Twin(torch, st, tb_state_err)
    now = 0
    for i in range(5):
        if i == 2:
            arr, n, now, facts = window_args(torch, np, dev, plan, tick=now)
        else:
            arr, n, now, facts = window_args(torch, np, dev, plan,
                                             *cb1_send(np, rng, i))
        nc = int(facts.cur.sum())
        if i == 4:
            timing["chunk"] = (tw.s[0].clone(), arr, n, now, nc)

        def step(s, f):
            cap = tb.out_capacity_chunk(s, nc, True)
            return f(s, arr, n, now, 0, cap, None, tb.MODE_CHUNK)
        tw.step(lambda s: step(s, tb.launch), lambda s: step(s, tb.plain),
                f"K12 chunk CB1 send {i}")
    e_chunk, rows_chunk = tw.err, tw.rows
    plan = window_plan(dev, CR1_QL, "cr1")
    tw = Twin(torch, plan.init_state()[0], tb_state_err)
    flushed = 0
    for i in range(12):
        cols, ts = cr1_send(np, rng, i)
        flush = i in (5, 10)
        if flush:
            # the fire and, in the same step, a few arrivals of the next
            # batch (they must not join the flush)
            m = min(1000, ts.shape[0])
            cols = [c[:m] for c in cols]
            ts = np.full(m, EX_T0 + 1000 * i, np.int64)
        arr, n, now, facts = window_args(torch, np, dev, plan, cols, ts)
        nc = int(facts.cur.sum())
        if i == 10:
            timing["cron"] = (tw.s[0].clone(), arr, n, now, nc)

        def step(s, f):
            cap = tb.out_capacity_cron(s, nc, flush)
            return f(s, arr, n, now, 0, cap, None, tb.MODE_CRON, flush)
        rows = tw.step(lambda s: step(s, tb.launch),
                       lambda s: step(s, tb.plain), f"K12 cron CR1 step {i}")
        flushed += int(rows.valid.sum())
    if flushed < 2 * 5 * CR1_B:
        fail(f"phase 37: CR1's fires flushed {flushed} rows")
    print(f"phase 37a K12 chunk: {rows_chunk} rows equal; cron: {tw.steps} "
          f"steps, {tw.rows} rows equal ({flushed} flushed)")
    return max(e_chunk, tw.err), timing


def compare_hop(torch, np, dev):
    """Phase 37b: K18 against its plain version at HP1's shape: seven
    sends (the window filling past 700,000 rows, hops collapsing within a
    send), a TIMER step at the next boundary and one past two boundaries,
    and a window of 131,072 rows whose kept rows overflow (counted in
    both).
    Returns (max error, timing inputs)."""
    from siddhi_tpu_torch.kernels import hop_window as hw
    rng = np.random.default_rng(153)
    plan = window_plan(dev, HP1_QL, "hp1")
    w = plan.window
    tw = Twin(torch, plan.init_state()[0], hop_state_err)
    small = Twin(torch, hw.HopState.empty(plan.in_schema, HP1_B, dev),
                 hop_state_err)
    timing, now = None, 0
    for i in range(9):
        if i >= 7:
            nxt = int(tw.s[0].meta[hw.NEXT])
            arr, n, now, _ = window_args(torch, np, dev, plan,
                                         tick=nxt + (i - 7) * 2 * HP1_HOP)
        else:
            arr, n, now, _ = window_args(torch, np, dev, plan,
                                         *hp1_send(np, rng, i))
        if i == 6:
            timing = (tw.s[0].clone(), arr, n, now)
        for t in (tw, small):
            t.step(lambda s: hw.launch(s, arr, n, now, w.win_ms, w.hop_ms),
                   lambda s: hw.plain(s, arr, n, now, w.win_ms, w.hop_ms),
                   f"K18 HP1 step {i}")
    if int(small.s[0].meta[hw.MISSED]) == 0:
        fail("phase 37: a hopping window below its rows reported no missed "
             "rows")
    print(f"phase 37b K18: {tw.steps + small.steps} steps, "
          f"{tw.rows + small.rows} rows equal ({int(tw.s[0].meta[0])} rows "
          f"retained; the small window missed "
          f"{int(small.s[0].meta[hw.MISSED])})")
    return max(tw.err, small.err), timing


# K19's edge cases (phase 37c and tests/test_torch_frequent.py): the
# window and what each send's keys exercise in the kernel's walk
FQ_EDGE_CASES = (
    ("full miss mid-group", "frequent(8, cardNo)"),
    ("repeated new keys in a group", "frequent(16, cardNo)"),
    ("full miss evicting every counter", "frequent(8, cardNo)"),
    ("keys colliding in the hash", "frequent(64, cardNo)"),
    ("only hits", "frequent(16, cardNo)"),
)


def fq_edge_keys(np, rng, case, A, i):
    """Send i's A keys (int64) of a K19 edge case.  "full miss mid-group":
    every key new, so the first group of 32 finds 8 free counters and its
    lane 8 is a full miss (which frees them all); "repeated new keys in a
    group": 12 new keys a send, each repeated in most groups; "full miss
    evicting every counter": blocks of 9 new keys, the 9th missing the 8
    counters that all hold count 1; "keys colliding in the hash": 300 keys
    whose first slot in the walk's hash of 64 counters is one (`key_slot`
    of the port's kernels/frequent.py); "only hits": 10
    keys in 16 counters, so every send after the first is all hits."""
    if case == "full miss mid-group":
        return (i * A + np.arange(A)).astype(np.int64)
    if case == "repeated new keys in a group":
        return (i * 1000 + rng.integers(0, 12, A)).astype(np.int64)
    if case == "full miss evicting every counter":
        g = i * A + np.arange(A)
        return (g // 9 * 100 + g % 9).astype(np.int64)
    if case == "keys colliding in the hash":
        from siddhi_tpu_torch.kernels.frequent import key_slot
        cand = np.arange(1 << 18, dtype=np.int64)
        h = key_slot(cand[:, None], 64)
        keys = cand[h == h[0]][:300]
        return keys[rng.integers(0, keys.shape[0], A)]
    return rng.integers(0, 10, A).astype(np.int64)


def compare_frequent(torch, np, dev):
    """Phase 37c: K19 against its plain version: FQ1's purchases (1,000
    counters in shared memory, three sends), 20,000 counters (beyond
    shared memory: the counters in device memory) over a small send,
    float keys (-0.0, +0.0, NaNs of two payloads) over two columns, and
    the walk's edge cases (FQ_EDGE_CASES: a full miss mid-group, repeated
    new keys in a group, a full miss evicting every counter, keys
    colliding in the hash, a batch of only hits).  Returns (max error,
    timing inputs)."""
    from siddhi_tpu_torch.kernels import frequent as fq
    rng = np.random.default_rng(157)
    err, timing, rows = 0.0, None, 0
    cases = [(FQ1_QL, [fq1_send(np, rng, i) for i in range(3)]),
             (FQ1_QL.replace("0.001, 0.0001", "0.00005"),
              [fq1_send(np, rng, i, 8192) for i in range(2)])]
    nan2 = np.array([0x7fc00001], np.uint32).view(np.float32)[0]
    fl = np.array([-0.0, 0.0, 0.5, np.nan, nan2, -1.5], np.float32)
    cases.append((FQ1_QL.replace("0.001, 0.0001, cardNo",
                                 "0.25, cardNo, price").replace(
                                     "[price >= 30]", ""),
                  [([rng.integers(0, 6, 4096).astype(np.int64),
                     fl[rng.integers(0, 6, 4096)]],
                    np.full(4096, 7 + i, np.int64)) for i in range(2)]))
    for name, win in FQ_EDGE_CASES:
        ql = FQ1_QL.replace("lossyFrequent(0.001, 0.0001, cardNo)",
                            win).replace("[price >= 30]", "")
        cases.append((ql, [([fq_edge_keys(np, rng, name, 4096, i),
                             rng.integers(0, 60, 4096).astype(np.float32)],
                            np.full(4096, 9 + i, np.int64))
                           for i in range(3)]))
    for c, (ql, sends) in enumerate(cases):
        plan = window_plan(dev, ql, "fq1")
        kp = plan.window.key_positions
        tw = Twin(torch, plan.init_state()[0], freq_state_err)
        for i, (cols, ts) in enumerate(sends):
            arr, n, now, _ = window_args(torch, np, dev, plan, cols, ts)
            if c == 0 and i == 2:
                timing = (tw.s[0].clone(), arr, n, kp)
            tw.step(lambda s: fq.launch(s, arr, n, kp),
                    lambda s: fq.plain(s, arr, n, kp),
                    f"K19 case {c} send {i}")
        err, rows = max(err, tw.err), rows + tw.rows
    print(f"phase 37c K19: {rows} rows equal over FQ1's sends, 20,000 "
          f"counters in device memory, float keys and the edge cases "
          f"({', '.join(n for n, _ in FQ_EDGE_CASES)})")
    return err, timing


def compare_latency(torch, np, dev):
    """Phase 37d: K11's latency mode against its plain version at SL1's
    shape (2^20 keys x 2 x 128 rows): sends with late clicks (into the
    current session, into the previous one, merging, dropped), a timer
    tick over every key, a hot key above its capacity (missed rows in
    both) and a session written out of ts order (the rank launch).
    Returns (max error, timing inputs)."""
    from siddhi_tpu_torch.kernels import keyed_window as kw
    rng = np.random.default_rng(159)
    stats = {"steps": 0, "rows": 0, "pads": 0}
    plan = keyed_plan(dev, SL1_QL, "sl1")
    torch.cuda.empty_cache()
    slab = plan.init_state()[0]
    slabs = [slab, slab.clone()]
    err, timing = 0.0, {}
    lat = plan.window.latency_ms
    steps = [sl1_send(np, rng, i) for i in range(0, 40, 2)]
    for i, (cols, ts) in enumerate(steps):
        args = keyed_args(torch, np, dev, plan, cols, ts)
        if i == len(steps) - 1:
            timing["data"] = (plan, slabs[0].clone(), args, lat)
        e, _ = keyed_twin(torch, kw, plan, slabs, args,
                          f"K11 latency SL1 send {i}", stats, lat=lat)
        err = max(err, e)
    # a tick that rotates every current session to previous, then one
    # past their alive times that expires them all
    t_rot = int(steps[-1][1].max()) + SL1_GAP
    for what, tick in (("rotating", t_rot),
                       ("expiring", t_rot + SL1_GAP + SL1_LAT)):
        args = keyed_args(torch, np, dev, plan, tick=tick)
        if what == "expiring":
            timing["tick"] = (plan, slabs[0].clone(), args, lat)
        e, rows = keyed_twin(torch, kw, plan, slabs, args,
                             f"K11 latency tick {what} over every key",
                             stats, lat=lat)
        err = max(err, e)
    n_tick = int(rows.ts.shape[0])
    if n_tick == 0:
        fail("phase 37: the expiring tick expired no session")
    # one user above 128 rows, whose clicks come out of ts order
    cols, ts = sl1_send(np, rng, 60)
    cols[0][:3 * SL1_C] = 12345
    ts[:3 * SL1_C] = ts[0] - rng.integers(0, 3000, 3 * SL1_C)
    args = keyed_args(torch, np, dev, plan, cols, ts)
    _, wa = kw.launch(slabs[0].clone(), plan.filter_spec, *args, lat=lat)
    e, _ = keyed_twin(torch, kw, plan, slabs, args, "K11 latency hot key",
                      stats, lat=lat)
    if int(wa[1]) <= 0:
        fail("phase 37: a latency session above its capacity reported no "
             "missed rows")
    err = max(err, e)
    args = keyed_args(torch, np, dev, plan,
                    tick=int(ts.max()) + SL1_GAP + SL1_LAT)
    e, rows = keyed_twin(torch, kw, plan, slabs, args,
                         "K11 latency tick expiring the hot key", stats,
                         lat=lat)
    err = max(err, e)
    print(f"phase 37d K11 latency: {stats['steps']} steps, {stats['rows']} "
          f"rows equal, {stats['pads']} padding key rows; the expiring tick "
          f"expired {n_tick} rows")
    del slabs, slab
    return err, timing


# -- their times -------------------------------------------------------------

def time_slice10(torch, np, dev, t_tb, t_hop, t_fq, t_lat):
    """Phase 38: each kernel at its configuration's step (CUDA-graph
    replays, the state restored before each) beside its plain version and
    the bound of the bytes the step must move."""
    from siddhi_tpu_torch.kernels import frequent as fq
    from siddhi_tpu_torch.kernels import hop_window as hw
    from siddhi_tpu_torch.kernels import keyed_window as kw
    from siddhi_tpu_torch.kernels import time_batch as tb
    res = {}
    for key, mode in (("chunk", tb.MODE_CHUNK), ("cron", tb.MODE_CRON)):
        saved, arr, n, now, nc = t_tb[key]
        work = saved.clone()
        flush = mode == tb.MODE_CRON
        cap = (tb.out_capacity_chunk(saved.clone(), nc, True)
               if mode == tb.MODE_CHUNK
               else tb.out_capacity_cron(saved.clone(), nc, flush))

        def restore():
            for a, b in zip(work_tensors(work), work_tensors(saved)):
                a.copy_(b)
        out = tb.launch(work, arr, n, now, 0, cap, None, mode, flush)[0]
        restore()
        nv = int(out.valid.sum())
        pend, prev = (int(x) for x in saved.meta[2:4].tolist())
        rb = 8 + 4 + sum(c.element_size() for c in saved.b_cols[0])
        na = int(n)
        res[f"time_batch_{key}"] = {
            "ms": graph_ms(torch, lambda: tb.launch(
                work, arr, n, now, 0, cap, None, mode, flush), 10, restore),
            "plain_ms": event_timer(torch, lambda: tb.plain(
                work, arr, n, now, 0, cap, None, mode, flush), 3, restore),
            **bound((pend + prev) * rb + 2 * na * rb + nv * row_bytes(out)),
            "shape": f"{prev} previous + {pend} pending rows, {na} "
                     f"arrivals, {nv} rows out"}
    saved, arr, n, now = t_hop
    work = saved.clone()
    w_ms, h_ms = HP1_WIN, HP1_HOP
    out = hw.launch(work, arr, n, now, w_ms, h_ms)[0]
    n_out = int(out.ts.shape[0])
    n_in, na = int(saved.meta[0]), int(n)
    rb = 8 + 4 + sum(c.element_size() for c in saved.b_cols[0])
    res["hop_window"] = {
        "ms": graph_ms(torch, lambda: hw.launch(
            work, arr, n, now, w_ms, h_ms, n_out=n_out), 10,
            lambda: work.copy_from(saved)),
        "plain_ms": event_timer(torch, lambda: hw.plain(
            work, arr, n, now, w_ms, h_ms), 3, lambda: work.copy_from(saved)),
        **bound((n_in + na) * rb + n_out * row_bytes(out) + na * rb),
        "rewrite_bytes": (n_in + na) * rb + n_out * row_bytes(out) +
        int(work.meta[0]) * rb,
        "shape": f"{n_in} rows retained, {na} arrivals, {n_out} rows out"}
    saved, arr, n, kp = t_fq
    work = saved.clone()
    out = fq.launch(work, arr, n, kp)
    n_out = int(out.ts.shape[0])
    na = int(n)
    rb = 8 + 4 + sum(c.element_size() for c in saved.cols)
    nk = saved.keys.shape[1]
    n_cur = int((out.kind == 0).sum())
    res["frequent"] = {
        "ms": graph_ms(torch, lambda: fq.launch(work, arr, n, kp,
                                                n_out=n_out), 3,
                       lambda: work.copy_from(saved)),
        "plain_ms": event_timer(torch, lambda: fq.plain(work, arr, n, kp),
                                1, lambda: work.copy_from(saved)),
        **bound(na * (rb + 8) + n_out * row_bytes(out) + n_cur * rb +
                2 * saved.n * 8 * (1 + nk)),
        "shape": f"{saved.n} counters, {na} arrivals, {n_out} rows out"}
    for key in ("data", "tick"):
        planned, saved, args, lat = t_lat[key]
        slab = saved.clone()
        sp = planned.filter_spec

        def restore():
            slab.copy_from(saved)
        restore()
        out = kw.launch(slab, sp, *args, lat=lat)[0]
        n_out = int(out.ts.shape[0])
        restore()
        # and each key row's previous count and its five session words
        nbytes = k11_bytes(torch, planned, saved, args, n_out) + \
            int((args[5] < saved.K).sum()) * 2 * (4 + 5 * 8)
        res[f"latency_{key}"] = {
            "ms": graph_ms(torch, lambda: kw.launch(slab, sp, *args,
                                                    n_out=n_out, lat=lat), 5,
                           restore),
            "plain_ms": event_timer(torch, lambda: kw.plain(
                slab, sp, *args, lat=lat), 1, restore),
            **bound(nbytes),
            "shape": f"{int(args[5].shape[0])} key rows, {n_out} rows out"}
        del slab
    return res


# -- the configurations through SiddhiManager --------------------------------

def run_cb1(torch, np, dev, mods):
    """CB1: batch() over 131,072-row chunks at 4,096 price levels: 2
    filling, 2 checked, 16 timed.  Returns K12's chunk launches."""
    tb = mods["time_batch"]
    rng = np.random.default_rng(161)
    n = CB1_FILL + CB1_CHECK + CB1_TIMED
    sends = [cb1_send(np, rng, i) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, CB1_QL, "cb1", "PriceStream", sends,
        CB1Model(np), (CB1_FILL, CB1_CHECK, True),
        "CB1 (batch(), 4,096 price levels)", CB1_TIMED * CB1_B,
        CB1_B * (4 + 4 + 8 + 4 + 1 + 4), ("filter_compact", "time_batch",
                                          "group_agg"))
    k = counts["time_batch"][0][tb.MODE_CHUNK]
    print(f"CB1: sends {CB1_FILL}-{CB1_FILL + CB1_CHECK - 1} held row by "
          f"row to the numpy model (each {2 * CB1_B} rows); K12 chunk "
          f"launches {k}")
    return k


def run_cr1(torch, np, dev, mods):
    """CR1: cron('*/5 * * * * ?') under playback at 4,096 symbols, 1 s of
    event time a send: 10 filling (two fires), 5 checked (one fire of
    655,360 pending rows), 16 timed.  Returns K12's cron launches."""
    tb = mods["time_batch"]
    rng = np.random.default_rng(163)
    n = CR1_FILL + CR1_CHECK + CR1_TIMED
    sends = [cr1_send(np, rng, i) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, CR1_QL, "cr1", "StockStream", sends,
        CR1Model(np), (CR1_FILL, CR1_CHECK, True),
        "CR1 (cron every 5 s, 4,096 symbols)", CR1_TIMED * CR1_B,
        CR1_B * (8 + 4 + 8 + 4 + 1 + 4), ("filter_compact", "time_batch",
                                          "group_agg"))
    fired = [r for r in res if r]
    if len(fired) < n // 5 - 1:
        fail(f"CR1: {len(fired)} fires over {n} sends")
    k = counts["time_batch"][0][tb.MODE_CRON]
    print(f"CR1: sends {CR1_FILL}-{CR1_FILL + CR1_CHECK - 1} held row by "
          f"row to the numpy model; rows a fire {min(fired)}-{max(fired)}; "
          f"K12 cron launches {k}")
    return k


def run_hp1(torch, np, dev, mods):
    """HP1: hopping(1 min, 10 sec) over 10,000 sensors reporting once a
    second (13.1 s of readings a send): 6 filling, 2 checked, 16 timed.
    Returns K18's launches."""
    rng = np.random.default_rng(165)
    n = HP1_FILL + HP1_CHECK + HP1_TIMED
    sends = [hp1_send(np, rng, i) for i in range(n + 4)]
    _, launches, res = run9(
        torch, np, dev, mods, HP1_QL, "hp1", "SensorStream", sends,
        HP1Model(np), (HP1_FILL, HP1_CHECK, True),
        "HP1 (hopping(1 min, 10 sec), 10,000 sensors)", HP1_TIMED * HP1_B,
        HP1_B * (8 + 4 + 4 + 8 + 4 + 1 + 4),
        ("filter_compact", "hop_window", "group_agg"))
    hops = [r for r in res if r]
    print(f"HP1: sends {HP1_FILL}-{HP1_FILL + HP1_CHECK - 1} held row by "
          f"row to the numpy model; CURRENT rows a hop {min(hops)}-"
          f"{max(hops)}; K18 launches {launches['hop_window']}")
    return launches["hop_window"]


def run_fq1(torch, np, dev, mods):
    """FQ1: lossyFrequent(0.001, 0.0001, cardNo) over purchase[price >=
    30], 1,000 counters, card numbers Zipf(1.1) over 2^20: 2 filling, 2
    checked row by row against FQ1Model, 16 timed.  Returns K19's
    launches."""
    rng = np.random.default_rng(167)
    n = FQ1_FILL + FQ1_CHECK + FQ1_TIMED
    sends = [fq1_send(np, rng, i) for i in range(n + 4)]
    model = FQ1Model(np)
    _, launches, res = run9(
        torch, np, dev, mods, FQ1_QL, "fq1", "purchase", sends, model,
        (FQ1_FILL, FQ1_CHECK, True),
        "FQ1 (lossyFrequent(0.001), 2^20 cards Zipf(1.1))",
        FQ1_TIMED * FQ1_B, FQ1_B * (8 + 4 + 8 + 4 + 1 + 4),
        ("filter_compact", "frequent"))
    print(f"FQ1: sends {FQ1_FILL}-{FQ1_FILL + FQ1_CHECK - 1} held row by "
          f"row to the numpy model; rows a send {min(res)}-{max(res)}; "
          f"hits {model.hits}, full misses {model.misses}; K19 launches "
          f"{launches['frequent']}")
    return launches["frequent"]


def run_sl1(torch, np, dev, mods):
    """SL1: session(5 sec, user, 2 sec) at 2^20 users, 65,536 users a
    send (two clicks each, 10% of clicks 0-7 s late), 250 ms apart under
    playback, three groups of users taking 3 s turns: 38 filling (the
    first group back from its turns away), 2 checked, 16 timed.  Returns
    K11's latency launches (timer ticks included)."""
    kw = mods["keyed_window"]
    rng = np.random.default_rng(169)
    n = SL1_FILL + SL1_CHECK + SL1_TIMED
    sends = [sl1_send(np, rng, i) for i in range(n + 4)]
    torch.cuda.empty_cache()
    model = SL1Model(np)
    counts, _, res = run9(
        torch, np, dev, mods, SL1_QL, "sl1", "ClickStream", sends, model,
        (SL1_FILL, SL1_CHECK, True),
        "SL1 (session(5 sec, user, 2 sec), 2^20 users)",
        SL1_TIMED * 2 * SL1_ROWS,
        keyed_h2d(np, sends[0][0][0], SL1_KEYS, 8 + 4 + 4),
        ("keyed_window", "group_agg"))
    modes, ticks = counts["keyed_window"]
    k = modes[kw.MODE_LATENCY]
    if not all(model.stats.values()):
        fail(f"SL1: a late branch never occurred: {model.stats}")
    print(f"SL1: sends {SL1_FILL}-{SL1_FILL + 1} held to the numpy model "
          f"(the expired and kept rows as multisets, the running totals); "
          f"branches {model.stats}; K11 latency launches {k} ({ticks} "
          f"ticks)")
    return k


def slice10_phases(torch, np, dev):
    """Phases 37-40: K12's chunk and cron modes, K18, K19 and K11's
    latency mode against their plain versions; their times; CB1, CR1,
    HP1, FQ1 and SL1 through SiddhiManager; X2's cases of these kinds.
    Returns their kernel records."""
    mods = slice10_modules()
    t0 = time.perf_counter()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 10 {what}: {time.perf_counter() - t0:.1f} s")
    e12, t_tb = compare_chunk_cron(torch, np, dev)
    e18, t_hop = compare_hop(torch, np, dev)
    e19, t_fq = compare_frequent(torch, np, dev)
    e11, t_lat = compare_latency(torch, np, dev)
    took("phase 37 done")
    res = time_slice10(torch, np, dev, t_tb, t_hop, t_fq, t_lat)
    del t_tb, t_hop, t_fq, t_lat
    took("phase 38 done")
    n = {"time_batch_chunk": run_cb1(torch, np, dev, mods)}
    took("CB1 done")
    n["time_batch_cron"] = run_cr1(torch, np, dev, mods)
    took("CR1 done")
    n["hop_window"] = run_hp1(torch, np, dev, mods)
    took("HP1 done")
    n["frequent"] = run_fq1(torch, np, dev, mods)
    took("FQ1 done")
    n["keyed_window_latency"] = run_sl1(torch, np, dev, mods)
    took("SL1 done")
    run_corpus(torch, np, dev, mods, "X2 (slice 10)", X10_CASES,
               ("time_batch", "hop_window", "frequent", "keyed_window"))
    took("phase 40 done")
    no_lib = "no single PyTorch call computes this window step"
    earlier = {"frequent": " (the earlier design, one warp scanning the "
                           "counters an arrival, took 274.8-277.7 ms an FQ1 "
                           "send on an H100 80GB HBM3 at 700 W; "
                           "scripts/time_k19_k8.py times both designs in "
                           "one call)"}
    records = []
    for name, key, src, rep, err in (
            ("time_batch_chunk", "time_batch_chunk", "time_batch.cu",
             "siddhi_tpu/core/window_ext.py:427", e12),
            ("time_batch_cron", "time_batch_cron", "time_batch.cu",
             "siddhi_tpu/core/window_ext.py:579", e12),
            ("hop_window", "hop_window", "hop_window.cu",
             "siddhi_tpu/core/window_ext.py:1166", e18),
            ("frequent", "frequent", "frequent.cu",
             "siddhi_tpu/core/window_ext.py:1023", e19),
            ("keyed_window_latency", "latency_data", "keyed_window.cu",
             "siddhi_tpu/core/window_ext.py:850", e11)):
        t = res[key]
        print(f"kernel {name}: {t['ms']:.4f} ms at {t['shape']} (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} bytes"
              f"{rewrite_note(t)}), plain {t['plain_ms']:.4f} ms, launches "
              f"on the main path {n[name]}; library_ms null: {no_lib}"
              f"{earlier.get(name, '')}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n[name], "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    t = res["latency_tick"]
    print(f"kernel latency_tick: {t['ms']:.4f} ms at {t['shape']} (bound "
          f"{t['bound_ms']:.5f} by {t['bound_by']}), plain "
          f"{t['plain_ms']:.4f} ms")
    return records


# X2: the slice's corpus (tests/test_window_ext.py, test_session_matrix.py,
# test_session_keyed.py, the distinct cases of test_join_groupby.py, a sort
# int-key asc case, a top-level distinctCount by page), under playback;
# _X2_WANT holds the JAX package's events (the CPU tests hold the cases to
# it)
_W = "@app:playback\ndefine stream S (eventTime long, v int, k string);\n"
_U = "@app:playback\ndefine stream S (user string, item int);\n"
_K = "@app:playback\ndefine stream S (user string, score int);\n"
_G = "@app:playback\ndefine stream S (g string, x string);\n"


def _sess(gap, sends, extra=""):
    return (_U + f"@info(name='q') from S#window.session({gap}{extra})\n"
            "select user, item insert all events into Out;",
            [("S", list(d), ts) for d, ts in sends])


_X2_SPECS = [
    ("externalTime sliding", _W + """@info(name='q')
from S#window.externalTime(eventTime, 1000)
select v, sum(v) as total insert all events into Out;""", "q",
     [("S", [1000, 1, "a"], 1000), ("S", [1500, 2, "b"], 1500),
      ("S", [2500, 4, "c"], 2500)]),
    ("externalTime out of order", _W + """@info(name='q')
from S#window.externalTime(eventTime, 1000)
select k, count() as n insert all events into Out;""", "q",
     [("S", [[3000, 1, "a"], [1000, 2, "b"], [2500, 3, "c"]], 1000),
      ("S", [[1200, 4, "d"], [4100, 5, "e"]], 1010),
      ("S", [[2000, 6, "f"], [2000, 7, "g"]], 1020),
      ("S", [[9000, 8, "h"]], 1030)]),
    ("externalTimeBatch", _W + """@info(name='q')
from S#window.externalTimeBatch(eventTime, 1000)
select sum(v) as total insert all events into Out;""", "q",
     [("S", [1000, 1, "a"], 1000), ("S", [1200, 2, "b"], 1200),
      ("S", [2100, 4, "c"], 2100), ("S", [3100, 8, "d"], 3100),
      ("S", [[5200, 1, "x"], [5300, 2, "y"]], 3200)]),
    ("externalTimeBatch with start", _W + """@info(name='q')
from S#window.externalTimeBatch(eventTime, 1 sec, 500)
select k, count() as n insert all events into Out;""", "q",
     [("S", [[700, 1, "a"], [1400, 2, "b"]], 1), ("S", [1600, 3, "c"], 2),
      ("S", [[2600, 4, "d"], [2400, 5, "e"]], 3)]),
    ("timeLength", _W + """@info(name='q')
from S#window.timeLength(600000, 2)
select k, sum(v) as total insert all events into Out;""", "q",
     [("S", [0, 1, "a"], 1000), ("S", [0, 2, "b"], 1001),
      ("S", [0, 4, "c"], 1002)]),
    ("timeLength time and length", _W + """@info(name='q')
from S#window.timeLength(2 sec, 3)
select k, count() as n insert all events into Out;""", "q",
     [("S", [0, 1, "a"], 1000), ("S", [0, 2, "b"], 1500),
      ("S", [[0, 3, "c"], [0, 4, "d"], [0, 5, "e"]], 1600),
      ("S", [0, 6, "f"], 4000), ("S", [0, 7, "g"], 7000)]),
    ("delay", _W + """@info(name='q')
from S#window.delay(1000) select k, v insert into Out;""", "q",
     [("S", [0, 1, "a"], 1000), ("S", [0, 2, "b"], 1400),
      ("S", [[0, 3, "c"], [0, 4, "d"]], 2600), ("S", [0, 5, "e"], 5000)]),
    ("sort int asc", _W + """@info(name='q')
from S#window.sort(2, v) select k, v insert all events into Out;""", "q",
     [("S", [0, 50, "a"], 1), ("S", [0, 20, "b"], 2), ("S", [0, 40, "c"], 3),
      ("S", [0, 10, "d"], 4), ("S", [[0, 30, "e"], [0, 5, "f"]], 5)]),
    ("sort desc", _W + """@info(name='q')
from S#window.sort(2, v, 'desc') select k, v insert all events into Out;""",
     "q", [("S", [0, 50, "a"], 1), ("S", [0, 20, "b"], 2),
           ("S", [0, 40, "c"], 3)]),
    ("session", _W + """@info(name='q')
from S#window.session(1000) select k, v insert expired events into Out;""",
     "q", [("S", [0, 1, "a"], 1000), ("S", [0, 2, "b"], 1500),
           ("S", [0, 3, "c"], 5000)]),
    ("session single timeout", *_sess("2 sec", [(["u", 101], 1000),
                                                (["tick", 0], 4000)])[:1],
     "q", _sess("2 sec", [(["u", 101], 1000), (["tick", 0], 4000)])[1]),
]
_SESS = [
    ("session two in turn", [(["u", 1], 1000), (["u", 2], 1500),
                             (["u", 3], 5000), (["u", 4], 5200),
                             (["end", 0], 9000)]),
    ("session boundary", [(["u", 1], 1000), (["u", 2], 3000),
                          (["end", 0], 6000)]),
    ("session late joins", [(["a", 101], 5000), (["b", 102], 5010),
                            (["late", 103], 4000), (["end", 0], 9000)]),
    ("session too late", [(["a", 101], 5000), (["dead", 103], 2500),
                          (["end", 0], 9000)]),
    ("session start moves back", [(["a", 1], 5000), (["late1", 2], 3500),
                                  (["late2", 3], 1800), (["end", 0], 9000)]),
    ("session gap from last", [(["u", i], 1000 + i * 1500) for i in range(6)]
     + [(["end", 0], 30000)]),
]
_X2_SPECS += [(n, _sess("2 sec", s)[0], "q", _sess("2 sec", s)[1])
              for n, s in _SESS]
_X2_SPECS += [
    ("session aggregate", _U + """@info(name='q') from S#window.session(1 sec)
select sum(item) as total insert expired events into Out;""", "q",
     [("S", ["u", 10], 1000), ("S", ["u", 20], 1500), ("S", ["u", 99], 5000),
      ("S", ["end", 1], 9000)]),
    ("session per key", _K + """@info(name='q')
from S#window.session(1 sec, user) select user, score
insert all events into Out;""", "q",
     [("S", ["alice", 1], 1000), ("S", ["bob", 10], 1600),
      ("S", ["alice", 2], 2100), ("S", ["carol", 99], 4000)]),
    ("session per key accumulates", _K + """@info(name='q')
from S#window.session(1 sec, user) select user, score
insert all events into Out;""", "q",
     [("S", ["u", 1], 1000), ("S", ["u", 2], 1500), ("S", ["u", 3], 4000)]),
    ("session per key sum", _K + """@info(name='q')
from S#window.session(1 sec, user) select sum(score) as total
insert all events into Out;""", "q",
     [("S", ["a", 1], 1000), ("S", ["b", 2], 1200), ("S", ["a", 3], 1500),
      ("S", ["c", 4], 5000)]),
    ("session per key group by", _K + """@info(name='q')
from S#window.session(1 sec, user) select user, sum(score) as total
group by user insert all events into Out;""", "q",
     [("S", [["a", 1], ["b", 2], ["a", 3]], 1000), ("S", ["b", 4], 1500),
      ("S", ["c", 4], 5000)]),
    ("session in a partition", _K + """partition with (user of S) begin
@info(name='q') from S#window.session(1 sec)
select user, count() as n insert all events into Out; end;""", "q",
     [("S", [["a", 1], ["b", 2]], 1000), ("S", ["a", 3], 1500),
      ("S", ["b", 4], 2600), ("S", ["c", 5], 6000)]),
    ("distinctCount", _G + """@info(name='q')
from S select g, distinctCount(x) as dc group by g insert into Out;""", "q",
     [("S", ["a", "x1"], 1), ("S", ["a", "x1"], 2), ("S", ["a", "x2"], 3),
      ("S", ["b", "x1"], 4), ("S", ["a", "x2"], 5)]),
    ("distinctCount batched", """@app:playback
define stream S (g long, x long);
@info(name='q')
from S select g, distinctCount(x) as dc group by g insert into Out;""", "q",
     [("S", [[1, 10], [1, 10], [1, 20], [2, 10], [2, 10], [1, 30]], 1)]),
    ("unionSet size", _G + """@info(name='q')
from S select g, sizeOfSet(unionSet(createSet(x))) as n
group by g insert into Out;""", "q",
     [("S", ["a", "x1"], 1), ("S", ["a", "x2"], 2), ("S", ["a", "x1"], 3),
      ("S", ["b", "y"], 4)]),
    ("distinctCount by page", """@app:playback
define stream ClickStream (user long, page int, dwell double);
@info(name='q') from ClickStream
select page, distinctCount(user) as users group by page insert into Out;""",
     "q", [("ClickStream", [[1, 7, 1.0], [2, 7, 0.0], [2, 7, 2.0],
                            [1, 8, 1.0]], 1),
           ("ClickStream", [[1, 7, 3.0], [3, 7, 1.0], [3, 8, 1.0]], 2)]),
    ("distinctCount in a partition", """@app:playback
define stream L (ip long, user long);
partition with (ip of L) begin
@info(name='q') from L select ip, distinctCount(user) as users,
count() as logins insert into Out; end;""", "q",
     [("L", [[1, 10], [1, 10], [2, 10], [1, 11]], 1),
      ("L", [[2, 11], [2, 12], [1, 10], [3, 1]], 2)]),
]

_X2_WANT = [[(1000, [(1000, (1, 1))], []), (1500, [(1500, (2, 3))], []),
  (2500, [(2500, (4, 4))], [(2000, (1, 2)), (2500, (2, None))])],
 [(1000, [(1000, ('b', 1)), (1000, ('c', 1)), (1000, ('a', 2))],
   [(2000, ('b', 0))]),
  (2000, [(1010, ('d', 3)), (1010, ('e', 1))],
   [(2200, ('d', 2)), (3500, ('c', 1)), (4000, ('a', 0))]),
  (4000, [(1020, ('f', 2)), (1020, ('g', 3))], []),
  (4000, [(1030, ('h', 1))],
   [(3000, ('f', 2)), (3000, ('g', 1)), (5100, ('e', 0))])],
 [(2100, [(1000, (1,)), (1200, (3,))], []),
  (3100, [(2100, (4,))], [(1000, (2,)), (1200, (None,))]),
  (3200, [(3100, (8,))], [(2100, (None,))])],
 [(2, [(1, ('a', 1)), (1, ('b', 2))], []),
  (3, [(2, ('c', 1)), (3, ('e', 2))], [(1, ('a', 1)), (1, ('b', 0))])],
 [(1000, [(1000, ('a', 1))], []), (1001, [(1001, ('b', 3))], []),
  (1002, [(1002, ('c', 6))], [(1002, ('a', 2))])],
 [(1000, [(1000, ('a', 1))], []), (1500, [(1500, ('b', 2))], []),
  (1600, [(1600, ('c', 1)), (1600, ('d', 2)), (1600, ('e', 3))],
   [(1600, ('a', 1)), (1600, ('b', 0))]),
  (3600, [], [(3600, ('c', 2)), (3600, ('d', 1)), (3600, ('e', 0))]),
  (4000, [(4000, ('f', 1))], []), (6000, [], [(6000, ('f', 0))]),
  (7000, [(7000, ('g', 1))], [])],
 [(2000, [(1000, ('a', 1))], []), (2400, [(1400, ('b', 2))], []),
  (3600, [(2600, ('c', 3)), (2600, ('d', 4))], [])],
 [(1, [(1, ('a', 50))], []), (2, [(2, ('b', 20))], []),
  (3, [(3, ('c', 40))], [(1, ('a', 50))]),
  (4, [(4, ('d', 10))], [(3, ('c', 40))]),
  (5, [(5, ('e', 30)), (5, ('f', 5))], [(2, ('b', 20)), (5, ('e', 30))])],
 [(1, [(1, ('a', 50))], []), (2, [(2, ('b', 20))], []),
  (3, [(3, ('c', 40))], [(2, ('b', 20))])],
 [(1000, [(1000, ('a', 1))], []), (1500, [(1500, ('b', 2))], []),
  (2500, [], [(1000, ('a', 1)), (1500, ('b', 2))]),
  (5000, [(5000, ('c', 3))], [])],
 [(1000, [(1000, ('u', 101))], []), (3000, [], [(1000, ('u', 101))]),
  (4000, [(4000, ('tick', 0))], [])],
 [(1000, [(1000, ('u', 1))], []), (1500, [(1500, ('u', 2))], []),
  (3500, [], [(1000, ('u', 1)), (1500, ('u', 2))]),
  (5000, [(5000, ('u', 3))], []), (5200, [(5200, ('u', 4))], []),
  (7200, [], [(5000, ('u', 3)), (5200, ('u', 4))]),
  (9000, [(9000, ('end', 0))], [])],
 [(1000, [(1000, ('u', 1))], []), (3000, [], [(1000, ('u', 1))]),
  (3000, [(3000, ('u', 2))], []), (5000, [], [(3000, ('u', 2))]),
  (6000, [(6000, ('end', 0))], [])],
 [(5000, [(5000, ('a', 101))], []), (5010, [(5010, ('b', 102))], []),
  (5010, [(4000, ('late', 103))], []),
  (6000, [],
   [(4000, ('late', 103)), (5000, ('a', 101)), (5010, ('b', 102))]),
  (9000, [(9000, ('end', 0))], [])],
 [(5000, [(5000, ('a', 101))], []), (7000, [], [(5000, ('a', 101))]),
  (9000, [(9000, ('end', 0))], [])],
 [(5000, [(5000, ('a', 1))], []), (5000, [(3500, ('late1', 2))], []),
  (5000, [(1800, ('late2', 3))], []),
  (3800, [],
   [(1800, ('late2', 3)), (3500, ('late1', 2)), (5000, ('a', 1))]),
  (9000, [(9000, ('end', 0))], [])],
 [(1000, [(1000, ('u', 0))], []), (2500, [(2500, ('u', 1))], []),
  (4000, [(4000, ('u', 2))], []), (5500, [(5500, ('u', 3))], []),
  (7000, [(7000, ('u', 4))], []), (8500, [(8500, ('u', 5))], []),
  (10500, [],
   [(1000, ('u', 0)), (2500, ('u', 1)), (4000, ('u', 2)), (5500, ('u', 3)),
    (7000, ('u', 4)), (8500, ('u', 5))]),
  (30000, [(30000, ('end', 0))], [])],
 [(1000, [(1000, (10,))], []), (1500, [(1500, (30,))], []),
  (2500, [], [(1000, (20,)), (1500, (None,))]), (5000, [(5000, (99,))], []),
  (6000, [], [(5000, (None,))]), (9000, [(9000, (1,))], [])],
 [(1000, [(1000, ('alice', 1))], []), (1600, [(1600, ('bob', 10))], []),
  (2000, [], [(1000, ('alice', 1))]), (2100, [(2100, ('alice', 2))], []),
  (2600, [], [(1600, ('bob', 10))]), (3100, [], [(2100, ('alice', 2))]),
  (4000, [(4000, ('carol', 99))], [])],
 [(1000, [(1000, ('u', 1))], []), (1500, [(1500, ('u', 2))], []),
  (2500, [], [(1000, ('u', 1)), (1500, ('u', 2))]),
  (4000, [(4000, ('u', 3))], [])],
 [(1000, [(1000, (1,))], []), (1200, [(1200, (3,))], []),
  (1500, [(1500, (6,))], []), (2200, [], [(1200, (4,))]),
  (2500, [], [(1000, (3,)), (1500, (None,))]), (5000, [(5000, (4,))], [])],
 [(1000, [(1000, ('a', 1)), (1000, ('a', 4)), (1000, ('b', 2))], []),
  (1500, [(1500, ('b', 6))], []),
  (2000, [], [(1000, ('a', 3)), (1000, ('a', None))]),
  (2500, [], [(1000, ('b', 4)), (1500, ('b', None))]),
  (5000, [(5000, ('c', 4))], [])],
 [(1000, [(1000, ('a', 1)), (1000, ('b', 1))], []),
  (1500, [(1500, ('a', 2))], []), (2000, [], [(1000, ('b', 0))]),
  (2500, [], [(1000, ('a', 1)), (1500, ('a', 0))]),
  (2600, [(2600, ('b', 1))], []), (3600, [], [(2600, ('b', 0))]),
  (6000, [(6000, ('c', 1))], [])],
 [(1, [(1, ('a', 1))], []), (2, [(2, ('a', 1))], []),
  (3, [(3, ('a', 2))], []), (4, [(4, ('b', 1))], []),
  (5, [(5, ('a', 2))], [])],
 [(1,
   [(1, (1, 1)), (1, (1, 1)), (1, (1, 2)), (1, (2, 1)), (1, (2, 1)),
    (1, (1, 3))],
   [])],
 [(1, [(1, ('a', 1))], []), (2, [(2, ('a', 2))], []),
  (3, [(3, ('a', 2))], []), (4, [(4, ('b', 1))], [])],
 [(1, [(1, (7, 1)), (1, (7, 2)), (1, (7, 2)), (1, (8, 1))], []),
  (2, [(2, (7, 2)), (2, (7, 3)), (2, (8, 2))], [])],
 [(1, [(1, (1, 1, 1)), (1, (1, 1, 2)), (1, (2, 1, 1)), (1, (1, 2, 3))], []),
  (2, [(2, (2, 2, 2)), (2, (2, 3, 3)), (2, (1, 2, 4)), (2, (3, 1, 1))],
   [])]]
X9_CASES = [spec + (want,) for spec, want in zip(_X2_SPECS, _X2_WANT)]

# X2's cases of slice 10 (tests/test_window_ext.py, test_session_latency.py,
# test_window_corpus.py, test_window_corpus2.py, and a collapsed hop, a
# grouped chunk, lossyFrequent's error parameter, late joins into the
# current session): batch, cron, hopping / hoping, frequent,
# lossyFrequent, session with allowed latency.  _X10_WANT holds the JAX
# package's events; cron's with the JAX scheduler's timer entries
# deduplicated as the port's scheduler keeps them (one flush per fire
# time; the JAX package queues a fire time once per step that schedules
# it and flushes again at each)
_B = "@app:playback\ndefine stream S (k string, v int);\n"
_P = "@app:playback\ndefine stream S (sym string, price float);\n"
_H = "@app:playback\ndefine stream S (sym string, v int);\n"
_L = ("@app:playback\ndefine stream S (user string, item int);\n"
      "@capacity(keys='16')\n"
      "@info(name='q') from S#window.session(2 sec, user, 1 sec)\n"
      "select user, item insert all events into Out;")
_S4 = [("S", ["a", 1.0], 1000), ("S", ["b", 2.0], 1001),
       ("S", ["c", 3.0], 1002), ("S", ["d", 4.0], 1003)]
_HOPS = [("S", [["a", 1]], 1000), ("S", [["b", 2]], 1500),
         ("S", [["c", 4]], 2200), ("S", [["d", 8]], 3100),
         ("S", [["e", 16]], 4100)]
_X10_SPECS = [
    ("batch chunk", _B + """@info(name='q') from S#window.batch()
select k, v insert all events into Out;""", "q",
     [("S", [["a", 1], ["b", 2]], 1000), ("S", [["c", 3]], 1100)]),
    ("batch golden", _P + """@info(name='q') from S#window.batch()
select sym, price insert all events into Out;""", "q", _S4),
    ("batch group by sum", _B + """@info(name='q') from S#window.batch(2)
select k, sum(v) as s group by k insert all events into Out;""", "q",
     [("S", [["a", 1], ["b", 2], ["a", 3]], 1000), ("S", [["a", 5]], 1100),
      ("S", [["b", 4], ["b", 6]], 1200)]),
    ("frequent one counter", _B + """@info(name='q')
from S#window.frequent(1, k) select k, v insert all events into Out;""",
     "q", [("S", ["a", 1], 1), ("S", ["a", 2], 2), ("S", ["b", 3], 3)]),
    ("frequent golden", """@app:playback
define stream S (sym string);
@info(name='q') from S#window.frequent(1, sym) select sym insert into Out;""",
     "q", [("S", [s], 1000) for s in ("a", "a", "b", "a")]),
    ("frequent every column", _B + """@info(name='q')
from S#window.frequent(2) select k, v insert all events into Out;""", "q",
     [("S", [["a", 1], ["a", 1], ["b", 2], ["c", 3], ["a", 1], ["d", 4]], 1),
      ("S", [["b", 2], ["b", 2], ["e", 5]], 2)]),
    ("lossyFrequent", _B + """@info(name='q')
from S#window.lossyFrequent(0.5, k) select k, v insert into Out;""", "q",
     [("S", ["x", 1], 1), ("S", ["x", 1], 2), ("S", ["x", 1], 3)]),
    ("lossyFrequent with error", _B + """@info(name='q')
from S#window.lossyFrequent(0.34, 0.01, k)
select k, count() as n insert all events into Out;""", "q",
     [("S", [["x", 1], ["y", 2], ["x", 3], ["z", 4]], 1),
      ("S", [["w", 5], ["x", 6], ["y", 7], ["v", 8]], 2)]),
    ("cron every second", """@app:playback
define stream S (v int);
@info(name='q') from S#window.cron('* * * * * ?')
select sum(v) as sv insert all events into Out;""", "q",
     [("S", [[1]], 100), ("S", [[2]], 300), ("S", [[10]], 1200),
      ("S", [[5]], 2500)]),
    ("cron every 5 seconds", _B + """@info(name='q')
from S#window.cron('*/5 * * * * ?')
select k, count() as n group by k insert all events into Out;""", "q",
     [("S", [["a", 1], ["b", 2]], 1000), ("S", [["a", 3]], 4000),
      ("S", [["a", 4]], 6000), ("S", [["b", 5]], 9000),
      ("S", [["c", 6]], 17000)]),
    ("hopping golden", _H + """@info(name='q')
from S#window.hopping(2 sec, 1 sec) select sym, sum(v) as sv
insert all events into Out;""", "q", _HOPS),
    ("hopping expired batch", _H + """@info(name='q')
from S#window.hopping(2 sec, 1 sec) select sym
insert expired events into Out;""", "q", _HOPS),
    ("hoping collapsed hops", _H + """@info(name='q')
from S#window.hoping(2 sec, 500) select sym, count() as n
insert all events into Out;""", "q",
     [("S", [["a", 1]], 1000), ("S", [["b", 2]], 1200),
      ("S", [["c", 4]], 1700), ("S", [["d", 8]], 4900),
      ("S", [["e", 16]], 5300)]),
    ("latency session two sessions", _L, "q",
     [("S", ["u", 101], 1000), ("S", ["u", 102], 1010),
      ("S", ["u", 103], 3510), ("S", ["u", 104], 3515),
      ("S", ["t", 0], 8000), ("S", ["t", 0], 20000)]),
    ("latency session late merge", _L, "q",
     [("S", ["u", 101], 1000), ("S", ["u", 108], 3500),
      ("S", ["u", 105], 2200), ("S", ["t", 0], 30000)]),
    ("latency session too late", _L, "q",
     [("S", ["u", 101], 10000), ("S", ["u", 200], 16000),
      ("S", ["u", 1], 2000), ("S", ["t", 0], 40000)]),
    ("latency session per key", _L, "q",
     [("S", ["a", 1], 1000), ("S", ["b", 2], 1100), ("S", ["a", 3], 4000),
      ("S", ["t", 0], 30000)]),
    ("latency session late into current", _L, "q",
     [("S", ["u", 1], 5000), ("S", ["u", 2], 4000), ("S", ["u", 3], 3500),
      ("S", [["u", 4], ["v", 5]], 9000), ("S", ["t", 0], 30000)]),
]
_X10_WANT = [[(1000, [(1000, ('a', 1)), (1000, ('b', 2))], []),
  (1100, [(1100, ('c', 3))], [(1000, ('a', 1)), (1000, ('b', 2))])],
 [(1000, [(1000, ('a', 1.0))], []),
  (1001, [(1001, ('b', 2.0))], [(1000, ('a', 1.0))]),
  (1002, [(1002, ('c', 3.0))], [(1001, ('b', 2.0))]),
  (1003, [(1003, ('d', 4.0))], [(1002, ('c', 3.0))])],
 [(1000, [(1000, ('a', 1)), (1000, ('b', 2)), (1000, ('a', 4))], []),
  (1100, [(1100, ('a', 5))],
   [(1000, ('a', 3)), (1000, ('b', None)), (1000, ('a', None))]),
  (1200, [(1200, ('b', 4)), (1200, ('b', 10))], [(1100, ('a', None))])],
 [(1, [(1, ('a', 1))], []), (2, [(2, ('a', 2))], [(2, ('a', 1))])],
 [(1000, [(1000, ('a',))], []), (1000, [(1000, ('a',))], [(1000, ('a',))]),
  (1000, [(1000, ('a',))], [(1000, ('a',))])],
 [(1,
   [(1, ('a', 1)), (1, ('a', 1)), (1, ('b', 2)), (1, ('a', 1)),
    (1, ('d', 4))],
   [(1, ('a', 1)), (1, ('b', 2)), (1, ('a', 1))]),
  (2, [(2, ('b', 2))], [(2, ('d', 4)), (2, ('a', 1)), (2, ('b', 2))])],
 [(1, [(1, ('x', 1))], []), (2, [(2, ('x', 1))], [(2, ('x', 1))]),
  (3, [(3, ('x', 1))], [(3, ('x', 1))])],
 [(1, [(1, ('x', 1)), (1, ('y', 2)), (1, ('x', 2))],
   [(1, ('x', 1)), (1, ('y', 1))]),
  (2, [(2, ('w', 2)), (2, ('x', 2)), (2, ('v', 2))],
   [(2, ('x', 1)), (2, ('w', 1))])],
 [(1000, [(100, (1,)), (300, (3,))], []),
  (2000, [(1200, (10,))], [(100, (2,)), (300, (None,))])],
 [(5000, [(1000, ('a', 1)), (1000, ('b', 1)), (4000, ('a', 2))], []),
  (10000, [(6000, ('a', 1)), (9000, ('b', 1))],
   [(1000, ('a', 1)), (1000, ('b', 0)), (4000, ('a', 0))]),
  (15000, [], [(6000, ('a', 0)), (9000, ('b', 0))])],
 [(2000, [(1000, ('a', 1)), (1500, ('b', 3))], []),
  (3000, [(1000, ('a', 1)), (1500, ('b', 3)), (2200, ('c', 7))],
   [(1000, ('a', 2)), (1500, ('b', None))]),
  (4000, [(2200, ('c', 4)), (3100, ('d', 12))],
   [(1000, ('a', 6)), (1500, ('b', 4)), (2200, ('c', None))])],
 [(2000, [(1000, ('a',)), (1500, ('b',))], []),
  (3000, [(1000, ('a',)), (1500, ('b',)), (2200, ('c',))],
   [(1000, ('a',)), (1500, ('b',))]),
  (4000, [(2200, ('c',)), (3100, ('d',))],
   [(1000, ('a',)), (1500, ('b',)), (2200, ('c',))])],
 [(1500, [(1000, ('a', 1)), (1200, ('b', 2))], []),
  (2000, [(1000, ('a', 1)), (1200, ('b', 2)), (1700, ('c', 3))],
   [(1000, ('a', 1)), (1200, ('b', 0))]),
  (2500, [(1000, ('a', 1)), (1200, ('b', 2)), (1700, ('c', 3))],
   [(1000, ('a', 2)), (1200, ('b', 1)), (1700, ('c', 0))]),
  (3000, [(1000, ('a', 1)), (1200, ('b', 2)), (1700, ('c', 3))],
   [(1000, ('a', 2)), (1200, ('b', 1)), (1700, ('c', 0))]),
  (3500, [(1700, ('c', 1))],
   [(1000, ('a', 2)), (1200, ('b', 1)), (1700, ('c', 0))]),
  (4000, [], [(1700, ('c', 0))]), (5000, [(4900, ('d', 1))], [])],
 [(1000, [(1000, ('u', 101))], []), (1010, [(1010, ('u', 102))], []),
  (3510, [(3510, ('u', 103))], []), (3515, [(3515, ('u', 104))], []),
  (4010, [], [(1000, ('u', 101)), (1010, ('u', 102))]),
  (6515, [], [(3510, ('u', 103)), (3515, ('u', 104))]),
  (8000, [(8000, ('t', 0))], []), (11000, [], [(8000, ('t', 0))]),
  (20000, [(20000, ('t', 0))], [])],
 [(1000, [(1000, ('u', 101))], []), (3500, [(3500, ('u', 108))], []),
  (3500, [(2200, ('u', 105))], []),
  (6500, [], [(1000, ('u', 101)), (2200, ('u', 105)), (3500, ('u', 108))]),
  (30000, [(30000, ('t', 0))], [])],
 [(10000, [(10000, ('u', 101))], []), (13000, [], [(10000, ('u', 101))]),
  (16000, [(16000, ('u', 200))], []), (19000, [], [(16000, ('u', 200))]),
  (40000, [(40000, ('t', 0))], [])],
 [(1000, [(1000, ('a', 1))], []), (1100, [(1100, ('b', 2))], []),
  (4000, [], [(1000, ('a', 1))]), (4000, [(4000, ('a', 3))], []),
  (4100, [], [(1100, ('b', 2))]), (7000, [], [(4000, ('a', 3))]),
  (30000, [(30000, ('t', 0))], [])],
 [(5000, [(5000, ('u', 1))], []), (5000, [(4000, ('u', 2))], []),
  (5000, [(3500, ('u', 3))], []),
  (8000, [], [(3500, ('u', 3)), (4000, ('u', 2)), (5000, ('u', 1))]),
  (9000, [(9000, ('u', 4)), (9000, ('v', 5))], []),
  (12000, [], [(9000, ('u', 4)), (9000, ('v', 5))]),
  (30000, [(30000, ('t', 0))], [])]]
X10_CASES = [spec + (want,) for spec, want in zip(_X10_SPECS, _X10_WANT)]
X2_CASES = X9_CASES + X10_CASES


# ---------------------------------------------------------------------------
# slice 11: eight B12 windows kept per partition key (K20 keyed_ext, K21
# keyed_batch, K22 keyed_sort, K23 keyed_hop in csrc/keyed_ext.cu)
# ---------------------------------------------------------------------------

KX_KEYS = 1 << 16
KX1_T, KX1_JIT = 60_000, 500
KX1_FILL, KX1_CHECK, KX1_TIMED = 30, 2, 16
KXB1_FILL, KXB1_CHECK, KXB1_TIMED = 30, 2, 16
KSO1_B, KSO1_N = 1 << 17, 10
KSO1_HOT = 1 << 14          # the hottest symbol's trades in the hot send
KSO1_FILL, KSO1_CHECK, KSO1_TIMED = 8, 2, 16
KHP1_WIN, KHP1_HOP = 60_000, 10_000
KHP1_FILL, KHP1_CHECK, KHP1_TIMED = 12, 2, 16

# KX1: EX1's app (the Siddhi 5.1 API reference's externalTime entry) kept
# per device: a sliding minute on each device's own readings
KX1_QL = """
define stream SensorStream (deviceID long, eventTime long, temp double);
partition with (deviceID of SensorStream)
begin
  @capacity(keys='{keys}', window='128')
  @info(name='kx1') from SensorStream#window.externalTime(eventTime, 1 min)
  select deviceID, avg(temp) as a, count() as n
  insert all events into Out;
end;
"""
# KXB1: a tumbling minute per device on the device's own clock
KXB1_QL = KX1_QL.replace("externalTime(", "externalTimeBatch(") \
    .replace("'kx1'", "'kxb1'")
# KSO1: SO1's app (the API reference's sort entry) kept per symbol: the
# top 10 trades of each symbol by price
KSO1_QL = """
define stream StockStream (symbol long, price double, volume int);
partition with (symbol of StockStream)
begin
  @capacity(keys='{keys}')
  @info(name='kso1') from StockStream#window.sort(10, price, 'desc')
  select symbol, price insert all events into Out;
end;
"""
# KHP1: HP1's window kept per sensor: a trailing minute every 10 s
KHP1_QL = """
@app:playback
define stream SensorStream (sensorID long, temp double);
partition with (sensorID of SensorStream)
begin
  @capacity(keys='{keys}', window='128')
  @info(name='khp1') from SensorStream#window.hopping(1 min, 10 sec)
  select sensorID, avg(temp) as a insert all events into Out;
end;
"""


def slice11_modules():
    from siddhi_tpu_torch.kernels import group_agg, keyed_ext
    return {"keyed_ext": keyed_ext, "group_agg": group_agg}


def kx1_send(np, rng, i, keys=KX_KEYS, stagger=False, jit=KX1_JIT):
    """KX1's send i (at 1,000 + i): two readings from each of `keys`
    devices (KXB1: from those that have joined, device d at send d mod
    30), 1 s apart in event time from EX_T0 + 2 s * i, each jittered back
    by up to `jit` ms, in a random order; integer temperatures 0-3."""
    dev = np.arange(keys, dtype=np.int64)
    if stagger:
        dev = dev[dev % 30 <= i]
    n = dev.shape[0]
    d = np.tile(dev, 2)
    r = np.repeat(np.arange(2, dtype=np.int64), n)
    et = EX_T0 + 1000 * (2 * i + r) - rng.integers(0, jit + 1, 2 * n)
    p = rng.permutation(2 * n)
    return ([d[p], et[p], rng.integers(0, 4, 2 * n)
             .astype(np.float32)[p]], np.full(2 * n, 1000 + i, np.int64))


def kxb1_send(np, rng, i, keys=KX_KEYS):
    """KXB1's send i: KX1's readings from the devices that have joined
    (device d at send d mod 30, so each device's minute starts 2 s after
    the one before's, and about 1/30 of them flush each send)."""
    return kx1_send(np, rng, i, keys, stagger=True)


def kso1_send(np, rng, i, b=KSO1_B, keys=KX_KEYS):
    """KSO1's send i (at 1,000 + i): b trades, symbols and prices (in
    quarters below 250) uniform."""
    return ([rng.integers(0, keys, b).astype(np.int64),
             rng.integers(0, 1000, b).astype(np.float32) / 4,
             rng.integers(1, 100, b).astype(np.int32)],
            np.full(b, 1000 + i, np.int64))


def khp1_send(np, rng, i, keys=KX_KEYS):
    """KHP1's send i: the readings of seconds 2i and 2i + 1 (at EX_T0 +
    1 s * second) of every sensor that has started (sensor d starts at
    second d mod 10), integer temperatures 0-3."""
    d = np.arange(keys, dtype=np.int64)
    ids, secs = [], []
    for s in (2 * i, 2 * i + 1):
        on = d[d % 10 <= s]
        ids.append(on)
        secs.append(np.full(on.shape[0], s, np.int64))
    ids, secs = np.concatenate(ids), np.concatenate(secs)
    return ([ids, rng.integers(0, 4, ids.shape[0]).astype(np.float32)],
            EX_T0 + 1000 * secs)


def key_blocks(np, what, dev):
    """The delivered rows' keys must come key-major (each key's rows
    together); returns the keys in their delivered order."""
    if dev.size == 0:
        return dev
    starts = np.r_[0, np.nonzero(dev[1:] != dev[:-1])[0] + 1]
    keys = dev[starts]
    if np.unique(keys).shape[0] != keys.shape[0]:
        fail(f"{what}: a key's rows are not together (rows not key-major)")
    return keys


def in_key_order(np, keys, lens, order):
    """Rows laid out key by key (`keys` ascending, `lens` rows each) taken
    in the key order `order`: (their row indices, each row's block)."""
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    pos = np.searchsorted(keys, order)
    ls, st = lens[pos], starts[pos]
    base = np.repeat(st - np.r_[0, np.cumsum(ls)[:-1]], ls)
    return base + np.arange(int(ls.sum())), np.repeat(
        np.arange(order.shape[0]), ls)


def masked_rows(np, keys, mask, *cols):
    """[K, W] blocks of rows (mask: which exist) flattened key by key:
    (keys with rows, their row counts, the flat columns)."""
    lens = mask.sum(1)
    has = lens > 0
    return keys[has], lens[has], [c[mask] for c in cols]


class EpochAgg:
    """A keyed selector's running count and float32 avg per key, with
    the selector's RESET epochs: within one step, a key's EXPIRED rows
    after k RESET rows start from zero (k > 0) or from the key's carried
    state (k = 0), and a flush's CURRENT rows follow its RESET; after a
    step with a RESET, only the keys whose rows count in the last epoch
    keep their state."""

    def __init__(self, np, keys):
        self.np = np
        self.cnt = np.zeros(keys, np.int64)
        self.sum = np.zeros(keys, np.float64)

    def run(self, dev, cur, val, block, resets):
        """Rows in delivered order: key, CURRENT flag, value, the index of
        the key's block; `resets`: each block is a flush (EXPIRED rows, a
        RESET, CURRENT rows).  Returns each row's count and avg."""
        np = self.np
        if dev.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        sign = np.where(cur, 1, -1)
        epoch = block + cur if resets else np.zeros_like(block)
        # every (key, epoch) is its own group
        gid = np.unique(np.stack([dev, epoch]), axis=1,
                        return_inverse=True)[1].reshape(-1)
        ng = int(gid.max()) + 1
        c0, s0 = np.zeros(ng, np.int64), np.zeros(ng)
        carried = np.zeros(ng, np.bool_)
        first = epoch == 0
        c0[gid[first]] = self.cnt[dev[first]]
        s0[gid[first]] = self.sum[dev[first]]
        carried[gid[first]] = True
        v = sign * val.astype(np.float64)
        c = c0[gid] + group_cumsum(np, gid, sign.astype(np.int64))
        s_run = s0[gid] + group_cumsum(np, gid, v)
        # a sum is -0 while every term (and a carried state) is -0: a group
        # that carries nothing starts from its first row, as the scan does
        pos = ~((v == 0) & np.signbit(v))
        neg0 = group_cumsum(np, gid, pos.astype(np.int64)) == 0
        neg0 &= ~carried[gid] | ((s0[gid] == 0) & np.signbit(s0[gid]))
        s_run = np.where((s_run == 0) & neg0, -0.0, s_run)
        with np.errstate(invalid="ignore", divide="ignore"):
            a = np.where(c != 0, s_run.astype(np.float32) /
                         c.astype(np.float32),
                         np.float32("nan")).astype(np.float32)
        last = np.zeros(ng, np.int64)
        last[gid] = np.arange(gid.shape[0])
        if resets:
            # the last flush's RESET opens the final epoch
            sel = epoch == int(block.max()) + 1
            self.cnt[:] = 0
            self.sum[:] = 0.0
        else:
            sel = np.ones(dev.shape[0], np.bool_)
        idx = last[gid[sel]]
        self.cnt[dev[idx]] = c[idx]
        self.sum[dev[idx]] = s_run[idx]
        return c, a


def check_keyed(np, what, batches, names, exp, agg, resets):
    """Holds one step's delivered rows to the model's rows (`exp`: keys
    ascending, their row counts, then kind, ts, value and more columns
    flat key by key): the same keys, each key's rows in the model's order,
    and (with `agg`) the running count / avg the selector gives them."""
    g_kind, g_ts, g = sent_rows(np, batches, names)
    dev = g[names[0]].astype(np.int64)
    order = key_blocks(np, what, dev)
    keys, lens = exp[0], exp[1]
    if not np.array_equal(np.sort(order), keys):
        fail(f"{what}: rows for {order.shape[0]} keys, the model has "
             f"{keys.shape[0]}")
    idx, block = in_key_order(np, keys, lens, order)
    kind, ts, val = (x[idx] for x in exp[2:5])
    expect(np, what, "kind", g_kind, kind)
    expect(np, what, "ts", g_ts, ts)
    expect(np, what, names[0], dev, np.repeat(order, lens[
        np.searchsorted(keys, order)]))
    if agg is None:
        for n, want in zip(names[1:], exp[4:]):
            expect(np, what, n, g[n], want[idx])
        return
    c, a = agg.run(dev, kind == 0, val, block, resets)
    expect(np, what, "a", g["a"], a)
    if "n" in g:
        expect(np, what, "n", g["n"].astype(np.int64), c)


def agg_unchecked(np, agg, exp, resets):
    """An unchecked step's aggregates, its keys taken in ascending order
    (the order decides only which key keeps its state after a RESET step,
    so a RESET step leaves every key at zero here)."""
    keys, lens = exp[0], exp[1]
    if keys.size == 0:
        return
    block = np.repeat(np.arange(keys.shape[0]), lens)
    agg.run(np.repeat(keys, lens), exp[2] == 0, exp[4], block, resets)
    if resets:
        agg.cnt[:] = 0
        agg.sum[:] = 0.0


class _Readings:
    """Per key, its readings of each send by index j (two a send, the
    earlier event time first): event time, arrival ts, value and place in
    the send's batch, in [keys, J] arrays."""

    def __init__(self, np, keys, sends):
        J = 2 * sends
        self.np = np
        self.ets = np.zeros((keys, J), np.int64)
        self.ts = np.zeros((keys, J), np.int64)
        self.val = np.zeros((keys, J), np.float32)
        self.pos = np.zeros((keys, J), np.int64)
        self.have = np.zeros((keys, sends), np.bool_)     # by send

    def add(self, i, dev, ets, ts, val, what):
        """Send i's readings: two of each key it holds."""
        np = self.np
        o = np.lexsort((ets, dev))
        d = dev[o]
        if d.shape[0] % 2 or not np.array_equal(d[0::2], d[1::2]) or \
                np.unique(d).shape[0] * 2 != d.shape[0]:
            fail(f"{what}: a send must hold two readings of each key")
        self.have[d[0::2], i] = True
        for r in range(2):
            k = o[r::2]
            for arr, src in ((self.ets, ets), (self.ts, ts),
                             (self.val, val)):
                arr[d[r::2], 2 * i + r] = src[k]
            self.pos[d[r::2], 2 * i + r] = k


class KX1Model:
    """KX1's windows in numpy: each device's readings (two a send, in
    event-time order, which is their (event time, arrival) order here),
    its count and exact temperature sum.  Over a send, a device's rows with
    ets + 1 min at or before its latest new ets expire (EXPIRED, ts = ets +
    1 min) and its two readings pass CURRENT, in the order of the keys
    2 (ets + t) and 2 ets + 1; a checked step holds every row, key by key,
    with the running avg and count."""

    def __init__(self, np, keys, sends=64, t=KX1_T):
        self.np, self.t, self.keys = np, t, keys
        self.r = _Readings(np, keys, sends)
        self.lo = np.zeros(keys, np.int64)
        self.agg = EpochAgg(np, keys)
        self.i = 0

    def step(self, cols, ts, batches, what):
        np, t, r, i = self.np, self.t, self.r, self.i
        self.i += 1
        r.add(i, cols[0], cols[1], ts, cols[2], what)
        D = self.keys
        if not r.have[:, i].all():
            fail(f"{what}: KX1 sends hold every device")
        now = r.ets[:, 2 * i + 1]
        W = 2 * (t // 2000) + 8           # the alive rows lie in W columns
        j0 = max(0, 2 * i - W)
        j = np.arange(j0, 2 * i)[None, :]
        due = (j >= self.lo[:, None]) & \
            (r.ets[:, j0:2 * i] + t <= now[:, None])
        cand = np.arange(D)[:, None]
        e_ets = r.ets[:, j0:2 * i]
        # per device: its expiring rows, then its two readings, ordered by
        # the emission keys
        key = np.concatenate([np.where(due, 2 * (e_ets + t), BIG),
                              2 * r.ets[:, 2 * i:2 * i + 2] + 1], 1)
        o = np.argsort(key, axis=1, kind="stable")
        ex = np.concatenate([due, np.ones((D, 2), np.bool_)], 1)
        kind = np.concatenate([np.ones_like(due, np.int32),
                               np.zeros((D, 2), np.int32)], 1)
        tss = np.concatenate([e_ets + t, r.ts[:, 2 * i:2 * i + 2]], 1)
        val = np.concatenate([r.val[:, j0:2 * i], r.val[:, 2 * i:2 * i + 2]],
                             1)

        def take(x):
            return np.take_along_axis(x, o, 1)
        exp = masked_rows(np, np.arange(D), take(ex), take(kind), take(tss),
                          take(val))
        exp = (exp[0], exp[1], *exp[2])
        self.lo += due.sum(1)
        if batches is not None:
            check_keyed(np, what, batches, ("deviceID", "a", "n"), exp,
                        self.agg, False)
        else:
            agg_unchecked(np, self.agg, exp, False)
        return int(due.sum())


class KXB1Model:
    """KXB1's slices in numpy: device d's slice of reading j is (ets_j -
    its first reading's ets) // 1 min, and its pending slice the one of its
    last flush (0 before any).  A send whose later reading of a device
    falls in a later slice flushes it: the previous slice EXPIRED, (a
    RESET row), the pending slice's readings CURRENT, each in arrival
    order (send, then place in the batch); the selector's RESET epochs run
    over the flushing devices in their delivered order.  A device sends
    two readings a send from the send it joins."""

    def __init__(self, np, keys, sends=64, t=KX1_T):
        self.np, self.t, self.keys = np, t, keys
        self.r = _Readings(np, keys, sends)
        self.cs = np.zeros(keys, np.int64)
        self.agg = EpochAgg(np, keys)
        self.i = 0

    def step(self, cols, ts, batches, what):
        np, t, r, i = self.np, self.t, self.r, self.i
        self.i += 1
        r.add(i, cols[0], cols[1], ts, cols[2], what)
        # each device's first reading (the index of the send it joined)
        first = 2 * np.argmax(r.have, axis=1)
        start = r.ets[np.arange(self.keys), first]
        hi = 2 * i + 2
        W = 4 * (t // 2000) + 8
        j0 = max(0, hi - W)
        jj = np.arange(j0, hi)[None, :]
        sl = np.where(jj >= first[:, None],
                      (r.ets[:, j0:hi] - start[:, None]) // t, -2)
        new = sl[:, -1]
        fl = r.have[:, i] & (new > self.cs)
        if np.any(new > self.cs + 1):
            fail(f"{what}: a device crossed two slice ends in one send")
        F = np.nonzero(fl)[0]
        cs = self.cs[F][:, None]
        s = sl[F]
        ex = s == cs - 1
        cu = s == cs
        akey = (jj // 2) * (1 << 40) + r.pos[F, j0:hi]
        key = np.where(ex, akey, np.where(cu, (1 << 60) + akey, BIG))
        o = np.argsort(key, axis=1, kind="stable")

        def take(x):
            return np.take_along_axis(x, o, 1)
        exp = masked_rows(np, F, take(ex | cu), take(np.where(ex, 1, 0)
                                                      .astype(np.int32)),
                          take(r.ts[F, j0:hi]), take(r.val[F, j0:hi]))
        exp = (exp[0], exp[1], *exp[2])
        self.cs[F] = new[F]
        if batches is not None:
            check_keyed(np, what, batches, ("deviceID", "a", "n"), exp,
                        self.agg, True)
        else:
            agg_unchecked(np, self.agg, exp, True)
        return int(F.shape[0])


class KSO1Model:
    """KSO1's standing top 10 per symbol in numpy (kept rows in candidate
    order): a symbol's trades pass CURRENT in send order, then its evicted
    rows leave EXPIRED in candidate order (the kept rows are its 10
    greatest prices, ties to the earlier candidate)."""

    def __init__(self, np, keys, n=KSO1_N):
        self.np, self.n = np, n
        self.ts = np.zeros((keys, n), np.int64)
        self.p = np.zeros((keys, n), np.float32)
        self.cnt = np.zeros(keys, np.int64)

    def step(self, cols, ts, batches, what):
        np, n = self.np, self.n
        sym, price = cols[0], cols[1]
        o = np.argsort(sym, kind="stable")
        s = sym[o]
        keys, starts, lens = np.unique(s, return_index=True,
                                       return_counts=True)
        E = int(lens.max()) if lens.size else 1
        k = np.arange(s.shape[0]) - np.repeat(starts, lens)
        a_p = np.zeros((keys.shape[0], E), np.float32)
        a_ts = np.zeros((keys.shape[0], E), np.int64)
        a_p[np.repeat(np.arange(keys.shape[0]), lens), k] = price[o]
        a_ts[np.repeat(np.arange(keys.shape[0]), lens), k] = ts[o]
        a_ok = np.arange(E)[None, :] < lens[:, None]
        b_ok = np.arange(n)[None, :] < self.cnt[keys][:, None]
        c_p = np.concatenate([self.p[keys], a_p], 1)
        c_ts = np.concatenate([self.ts[keys], a_ts], 1)
        c_ok = np.concatenate([b_ok, a_ok], 1)
        key = np.where(c_ok, -c_p.astype(np.float64), np.inf)
        rank = np.empty_like(key, dtype=np.int64)
        np.put_along_axis(rank, np.argsort(key, axis=1, kind="stable"),
                          np.arange(key.shape[1])[None, :].repeat(
                              key.shape[0], 0), 1)
        total = c_ok.sum(1)
        keep = c_ok & (rank < np.minimum(total, n)[:, None])
        ev_ = c_ok & ~keep
        exp = masked_rows(
            np, keys, np.concatenate([a_ok, ev_], 1),
            np.concatenate([np.zeros_like(a_ok, np.int32),
                            np.ones_like(ev_, np.int32)], 1),
            np.concatenate([a_ts, c_ts], 1), np.concatenate([a_p, c_p], 1))
        ko = np.argsort(~keep, axis=1, kind="stable")[:, :n]
        self.p[keys] = np.take_along_axis(c_p, ko, 1)
        self.ts[keys] = np.take_along_axis(c_ts, ko, 1)
        self.cnt[keys] = keep.sum(1)
        if batches is not None:
            check_keyed(np, what, batches, ("symbol", "price"),
                        (exp[0], exp[1], *exp[2]), None, False)
        return int(ev_.sum())


class KHP1Model:
    """KHP1's hopping windows in numpy, from the traffic's regular shape
    (sensor d reads once a second from second d mod 10, a send carrying two
    seconds): d's boundaries are at its first second + 10, + 20, ...  From
    second 10 the timer ticks every second before each send's batch (each
    tick's wake is the next second), and a tick at second s flushes the
    sensors with a boundary there: their readings of [s - 70, s - 10)
    EXPIRED, (a RESET row), of [s - 60, s) CURRENT, in second order, from
    the readings that have arrived (the seconds before the send); the data
    steps flush nothing.  The selector's RESET epochs run over each
    tick's sensors in their delivered order."""

    def __init__(self, np, keys, sends=64, win=KHP1_WIN, hop=KHP1_HOP):
        self.np, self.keys = np, keys
        self.win, self.hop = win // 1000, hop // 1000
        self.temp = np.zeros((keys, 2 * sends), np.float32)
        self.agg = EpochAgg(np, keys)
        self.i = 0

    def step(self, cols, ts, batches, what):
        np, i = self.np, self.i
        self.i += 1
        sec = (ts - EX_T0) // 1000
        d = np.arange(self.keys)
        want = np.r_[d[d % 10 <= 2 * i], d[d % 10 <= 2 * i + 1]]
        if not np.array_equal(np.sort(cols[0]), np.sort(want)):
            fail(f"{what}: not KHP1's regular readings")
        self.temp[cols[0], sec] = cols[1]
        ticks = [s for s in (2 * i, 2 * i + 1) if s >= 10]
        if batches is not None:
            got = [b for b in batches if b["n_valid"]]
            if len(got) != len(ticks):
                fail(f"{what}: {len(got)} steps delivered rows, the model "
                     f"has {len(ticks)} ticks")
        win, hop = self.win, self.hop
        flushed = 0
        for j, s in enumerate(ticks):
            F = d[(s >= d % 10 + hop) & ((s - d % 10) % hop == 0)]
            flushed += F.shape[0]
            S = np.arange(s - win - hop, s)[None, :]
            arrived = (S >= (F % 10)[:, None]) & (S < 2 * i) & (S >= 0)
            ex = arrived & (S < s - hop)
            cu = arrived & (S >= s - win)
            Sc = np.clip(S, 0, None).repeat(F.shape[0], 0)
            t_all = EX_T0 + 1000 * Sc
            v = self.temp[F[:, None], Sc]
            exp = masked_rows(
                np, F, np.concatenate([ex, cu], 1),
                np.concatenate([np.ones_like(ex, np.int32),
                                np.zeros_like(cu, np.int32)], 1),
                np.concatenate([t_all, t_all], 1), np.concatenate([v, v], 1))
            exp = (exp[0], exp[1], *exp[2])
            if batches is not None:
                check_keyed(np, f"{what} tick at second {s}", [got[j]],
                            ("sensorID", "a"), exp, self.agg, True)
            else:
                agg_unchecked(np, self.agg, exp, True)
        return flushed


# -- the kernels against their plain versions --------------------------------

def kx_prm(planned):
    from siddhi_tpu_torch.core.planner import _keyed_shape
    return _keyed_shape(planned.window, planned.name)[2]["prm"]


def with_timer(torch, args):
    """The same step with a valid TIMER row (ts = now) put first in the
    batch and in every key row's events (a cron fire that carries
    arrivals)."""
    ts, kind, valid, gslot, cols, key_idx, sel, now = args[:8]
    dev = ts.device

    def one(x, v):
        return torch.cat([torch.full((1,), v, dtype=x.dtype, device=dev), x])
    sel2 = torch.where(sel >= 0, sel + 1, sel)
    sel2 = torch.cat([torch.zeros((sel.shape[0], 1), dtype=sel.dtype,
                                  device=dev), sel2], 1).contiguous()
    return (one(ts, now), one(kind, 2), one(valid, True), one(gslot, 0),
            [one(c, 0) for c in cols], key_idx, sel2, now)


def kx_twin(torch, planned, slabs, args, what, stats, tick=False):
    """One K20-K23 step on slabs[0] and its plain version on slabs[1]:
    every emitted row, the wake and missed words and the whole slab
    compared (exact)."""
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    args = tuple(args[:8])
    prm = kx_prm(planned)
    spec = planned.filter_spec
    for s in slabs:
        ke.fit(s, int(args[6].shape[1]))
    ra, wa = ke.launch(slabs[0], spec, *args, prm, tick=tick)
    rb, wb = ke.plain(slabs[1], spec, *args, prm)
    torch.cuda.synchronize()
    err = rows_err(torch, ra, rb, what, full=True)
    err = max(err, float_err(torch, wa, wb, f"{what} wake"),
              slab_err(torch, slabs[0], slabs[1], what))
    stats["steps"] += 1
    stats["rows"] += int(ra.ts.shape[0])
    stats["pads"] += int((args[5] >= planned.key_capacity).sum())
    stats["missed"] += int(wa[1])
    return err, ra


def kx_fill(torch, planned, slabs, args):
    """A step on the kernel alone (filling a window), the plain slab then
    made its copy."""
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    args = tuple(args[:8])
    ke.fit(slabs[0], int(args[6].shape[1]))
    ke.launch(slabs[0], planned.filter_spec, *args, kx_prm(planned))


def compare_keyed_ext(torch, np, dev, keys=KX_KEYS):
    """Phase 41: K20 (externalTime, timeLength, delay), K21
    (externalTimeBatch, batch, cron), K22 and K23 against their plain
    versions at 65,536 keys: from empty slabs and from filled ones (KX1's
    and KXB1's minute, KSO1's top 10, KHP1's hops), with padding key rows
    (a send from part of the keys), a valid TIMER row in every key row
    beside its arrivals (a cron fire that carries arrivals; the other
    modes ignore it), out-of-order event times (jitter of 5 s against 1 s
    apart), timer ticks over every key, collapsed hops, a key past its
    capacity (counted as missed in both), and sort keys that tie with the
    dead places (-inf under 'desc'), NaN and -0.  Every row, the wake,
    missed and the slab compared.  Returns (max error, timing inputs by
    mode, stats)."""
    from siddhi_tpu_torch.kernels import keyed_window as kw
    rng = np.random.default_rng(171)
    stats = {"steps": 0, "rows": 0, "pads": 0, "missed": 0}
    timing, err = {}, 0.0

    def run(ql, qname, mode, steps, fill=(), time_at=None):
        """steps: [(label, a callable of the plan giving the args)];
        `fill`: the indices of steps run on the kernel alone; `time_at`:
        the label of the step phase 42 times."""
        nonlocal err
        plan = keyed_plan(dev, ql.format(keys=keys), qname)
        slab = plan.init_state()[0]
        if slab.mode != mode:
            fail(f"phase 41: {qname} planned in mode {slab.mode}")
        slabs = [slab, slab.clone()]
        for j, (label, mk) in enumerate(steps):
            args = mk(plan)
            if j in fill:
                kx_fill(torch, plan, slabs, args)
                if j + 1 not in fill:
                    slabs[1] = slabs[0].clone()
                continue
            if label == time_at:
                timing[mode] = (plan, slabs[0].clone(), tuple(args[:8]),
                                label)
            e, _ = kx_twin(torch, plan, slabs, args,
                           f"phase 41 {qname} {label}", stats,
                           tick=label.startswith("tick"))
            err = max(err, e)

    def send(fn, i, *a, **k):
        return lambda p: keyed_args(torch, np, dev, p, *fn(np, rng, i, *a,
                                                            **k))

    def tick(t):
        return lambda p: keyed_args(torch, np, dev, p, tick=t)

    def timer(fn, i, *a):
        return lambda p: with_timer(torch, keyed_args(
            torch, np, dev, p, *fn(np, rng, i, *a)))

    part = max(keys // 20 + 3, 3)       # part of the keys: padding rows
    # K20 externalTime at KX1: 2 sends from empty, 26 filling, then steady
    # sends, a partial one, a TIMER row beside the arrivals, a late one
    steps = [(f"send {i}", send(kx1_send, i, keys)) for i in range(30)]
    steps += [("partial send", send(kx1_send, 30, part)),
              ("send with a TIMER row", timer(kx1_send, 31, keys)),
              ("out-of-order send", send(kx1_send, 32, keys, False, 5000))]
    run(KX1_QL, "kx1", kw.MODE_EXT, steps, fill=range(2, 28),
        time_at="send 29")
    # keys of 8,192 rows: a key's workspace past the shared memory (the
    # global workspace, a block looping over the key rows), at 64 keys
    ql = KX1_QL.replace("{keys}", "64").replace("window='128'",
                                                "window='8192'")
    run(ql.replace("'kx1'", "'kxw'"), "kxw", kw.MODE_EXT,
        [(f"send {i}", send(kx1_send, i, 64, False, 30_000))
         for i in range(4)])
    # K20 timeLength(2 sec, 8) and delay(1 sec) at KX1's traffic: sends
    # 500 ms apart (playback ts), ticks between
    for win, qname, mode in (("timeLength(2 sec, 8)", "ktl", kw.MODE_TLEN),
                             ("delay(1 sec)", "kdl", kw.MODE_DELAY)):
        ql = KX1_QL.replace("externalTime(eventTime, 1 min)", win) \
            .replace("'kx1'", f"'{qname}'")

        def at(i, n=keys, t0=EX_T0):
            def mk(p):
                cols, _ = kx1_send(np, rng, i, n)
                return keyed_args(torch, np, dev, p, cols,
                                  np.full(cols[0].shape[0], t0 + 500 * i,
                                          np.int64))
            return mk
        steps = [(f"send {i}", at(i)) for i in range(6)]
        steps += [("tick", tick(EX_T0 + 2600)), ("partial send", at(6, part)),
                  ("send with a TIMER row",
                   lambda p: with_timer(torch, at(7)(p))),
                  ("tick", tick(EX_T0 + 9000))]
        run(ql, qname, mode, steps, time_at="send 5")
    # K21 externalTimeBatch at KXB1: 2 from empty, 26 filling, 3 steady
    # (about 2,185 devices flush a send), a partial send, a TIMER row
    steps = [(f"send {i}", send(kxb1_send, i, keys)) for i in range(31)]
    steps += [("partial send", send(kxb1_send, 31, part)),
              ("send with a TIMER row", timer(kxb1_send, 32, keys))]
    run(KXB1_QL, "kxb1", kw.MODE_XBATCH, steps, fill=range(2, 28),
        time_at="send 30")
    # K21 batch(): two readings a key a send; a hot key of 100 (the slab
    # grows past 64)
    ql = KX1_QL.replace("externalTime(eventTime, 1 min)", "batch()") \
        .replace("'kx1'", "'kcb'")

    def hot(p):
        cols, ts = kx1_send(np, rng, 5, keys)
        cols[0][:100] = 7
        return keyed_args(torch, np, dev, p, cols, ts)
    steps = [(f"send {i}", send(kx1_send, i, keys)) for i in range(4)]
    steps += [("hot key", hot), ("partial send", send(kx1_send, 6, part)),
              ("send with a TIMER row", timer(kx1_send, 7, keys))]
    run(ql, "kcb", kw.MODE_CHUNK, steps, time_at="send 3")
    # K21 cron: sends, a fire that carries arrivals, a tick, sends, a tick
    ql = KX1_QL.replace("externalTime(eventTime, 1 min)",
                        "cron('*/5 * * * * ?')").replace("'kx1'", "'kcr'")
    steps = [(f"send {i}", send(kx1_send, i, keys)) for i in range(3)]
    steps += [("fire with arrivals", timer(kx1_send, 3, keys)),
              ("tick", tick(EX_T0 + 10_000)),
              ("partial send", send(kx1_send, 4, part)),
              ("send", send(kx1_send, 5, keys)),
              ("tick", tick(EX_T0 + 15_000))]
    run(ql, "kcr", kw.MODE_CRON, steps, time_at="fire with arrivals")
    # K22 at KSO1: 2 from empty, 6 filling, 2 steady, a partial send, a
    # send with -inf (ties the dead places under 'desc'), NaN, 0 and -0
    steps = [(f"send {i}", send(kso1_send, i, KSO1_B * keys // KX_KEYS,
                                keys)) for i in range(10)]

    def odd(p):
        cols, ts = kso1_send(np, rng, 11, 4 * keys, keys)
        m = rng.random(cols[1].shape[0])
        cols[1][m < 0.1] = -np.inf
        cols[1][(m >= 0.1) & (m < 0.2)] = np.nan
        cols[1][(m >= 0.2) & (m < 0.3)] = -0.0
        cols[1][(m >= 0.3) & (m < 0.4)] = 0.0
        return keyed_args(torch, np, dev, p, cols, ts)
    steps += [("partial send", send(kso1_send, 10, part, keys)),
              ("send with -inf, NaN, 0, -0", odd),
              ("send with a TIMER row",
               timer(kso1_send, 12, KSO1_B * keys // KX_KEYS, keys))]
    run(KSO1_QL, "kso1", kw.MODE_SORT, steps, fill=range(2, 8),
        time_at="send 9")
    compare_sort_modes(torch, np, dev, rng, keys, run, stats, timing)
    # K23 at KHP1: 12 data sends (the first 2 compared), ticks at the next
    # boundaries, a partial send, a TIMER row, a tick 35 s on (collapsed
    # hops), then a window of 24 rows a key that misses rows
    steps = [(f"send {i}", send(khp1_send, i, keys)) for i in range(12)]
    steps += [("tick 24 s", tick(EX_T0 + 24_000)),
              ("tick 25 s", tick(EX_T0 + 25_000)),
              ("partial send", send(khp1_send, 12, part)),
              ("send with a TIMER row", timer(khp1_send, 13, keys)),
              ("tick collapsed", tick(EX_T0 + 62_000))]
    run(KHP1_QL, "khp1", kw.MODE_HOP, steps, fill=range(2, 11),
        time_at="tick 25 s")

    def hot_hop(p):
        cols, ts = khp1_send(np, rng, 0, part)
        cols = [np.r_[cols[0], np.full(200, 3, np.int64)],
                np.r_[cols[1], np.zeros(200, np.float32)]]
        return keyed_args(torch, np, dev, p, cols,
                          np.r_[ts, EX_T0 + np.arange(200, dtype=np.int64)])
    before = stats["missed"]
    run(KHP1_QL.replace("'khp1'", "'khs'"), "khs", kw.MODE_HOP,
        [("a sensor of 200 readings", hot_hop)])
    if stats["missed"] == before:
        fail("phase 41: a sensor of 200 readings in a slab of 128 rows a key "
             "missed no rows")
    if not stats["pads"]:
        fail("phase 41: no padding key rows were compared")
    print(f"phase 41 K20-K23: {stats['steps']} steps, {stats['rows']} rows "
          f"equal to the plain versions ({stats['pads']} padding key rows, "
          f"{stats['missed']} rows missed in both), max_abs_err {err}")
    return err, timing, stats


def sort_ql(n, qname):
    return KSO1_QL.replace("sort(10,", f"sort({n},").replace("'kso1'",
                                                           f"'{qname}'")


def per_symbol(np, rng, i, per, nsym):
    """`per` trades of each of `nsym` symbols (at 1,000 + i), in a random
    order: every key row of the send holds exactly `per` arrivals (`per`
    an int, or an array of one count a symbol)."""
    sym = np.repeat(np.arange(nsym, dtype=np.int64), per)
    p = rng.permutation(sym.shape[0])
    return ([sym[p], (rng.integers(0, 1000, sym.shape[0]) / 4)
             .astype(np.float32), rng.integers(1, 100, sym.shape[0])
             .astype(np.int32)], np.full(sym.shape[0], 1000 + i, np.int64))


# the extra columns of the wide KSO1 schemas, in the order they are added
WIDE_COLS = ("bid float", "venue int", "odd bool", "ask double", "lot long",
             "side int", "ok bool")


def wide_ql(ncols, qname):
    """KSO1's app over a schema of `ncols` columns (its three, then
    WIDE_COLS), the query named `qname`."""
    schema = ", ".join(("symbol long, price double, volume int",)
                       + WIDE_COLS[:ncols - 3])
    return KSO1_QL.replace("symbol long, price double, volume int",
                           schema).replace("'kso1'", f"'{qname}'")


def wide_send(np, rng, i, ncols, keys=KX_KEYS):
    """KSO1's send i with the extra columns of `wide_ql(ncols)`, random by
    type."""
    cols, ts = kso1_send(np, rng, i, KSO1_B * keys // KX_KEYS, keys)
    b = cols[0].shape[0]
    mk = {"float": lambda: rng.random(b, dtype=np.float32),
          "int": lambda: rng.integers(-9, 9, b).astype(np.int32),
          "bool": lambda: rng.random(b) < 0.5,
          "double": lambda: rng.random(b, dtype=np.float32) - 0.5,
          "long": lambda: rng.integers(-2 ** 40, 2 ** 40, b)}
    return cols + [mk[c.split()[1]]() for c in WIDE_COLS[:ncols - 3]], ts


def kso1_hot_send(np, rng, i, keys=KX_KEYS, hot=KSO1_HOT):
    """A KSO1 send whose symbol 7 carries `hot` of its trades (the others
    moved off it)."""
    cols, ts = kso1_send(np, rng, i, KSO1_B * keys // KX_KEYS, keys)
    cols[0][cols[0] == 7] = 8
    cols[0][:hot] = 7
    p = rng.permutation(cols[0].shape[0])
    return [c[p] for c in cols], ts


def plain_by_rows(torch, planned, slab, args, rows=2048):
    """The plain K20-K23 step over `rows` key rows at a time, for a step
    whose [Kb, E] plain state would not fit the card at once (a step's
    key rows are independent, and its rows come out key-major in key_idx
    order); returns each part's (rows, wake)."""
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    ts, kind, valid, gslot, cols, key_idx, sel, now = tuple(args[:8])
    return [ke.plain(slab, planned.filter_spec, ts, kind, valid, gslot, cols,
                     key_idx[r0:r0 + rows].contiguous(),
                     sel[r0:r0 + rows].contiguous(), now, kx_prm(planned))
            for r0 in range(0, key_idx.shape[0], rows)]


def kx_twin_rows(torch, planned, slabs, args, what, stats):
    """kx_twin with the plain side run by `plain_by_rows`."""
    from siddhi_tpu_torch.core.window import Rows
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    ra, wa = ke.launch(slabs[0], planned.filter_spec, *args[:8],
                       kx_prm(planned))
    parts = plain_by_rows(torch, planned, slabs[1], args)
    torch.cuda.synchronize()

    def cat(f):
        xs = [getattr(r, f) for r, _ in parts]
        return None if xs[0] is None else torch.cat(xs)
    rb = Rows(ts=cat("ts"), kind=cat("kind"), valid=cat("valid"),
              seq=cat("seq"), gslot=cat("gslot"),
              cols=tuple(torch.cat([r.cols[j] for r, _ in parts])
                         for j in range(len(parts[0][0].cols))))
    err = rows_err(torch, ra, rb, what, full=True)
    for _, wb in parts:
        err = max(err, float_err(torch, wa, wb, f"{what} wake"))
    err = max(err, slab_err(torch, slabs[0], slabs[1], what))
    stats["steps"] += 1
    stats["rows"] += int(ra.ts.shape[0])
    return err


def compare_sort_modes(torch, np, dev, rng, keys, run, stats, timing):
    """Phase 41's K22 cases beyond KSO1's steps: a key row of C + E = 33
    places (two candidates a lane), rows of C + E = 80 and 200 (a kept
    mask of 3 and 7 words, narrower than the 4 and 8 a lane bucket ranks)
    with full rows beside short ones in key_idx, rows at the warp limit
    (C + E = SORT_LIMIT, warp mode) and one above it (block mode), KSO1
    over schemas of 6 and 10 columns (the write's 8- and 16-column rows),
    and a KSO1 send whose hottest symbol carries 16,384 of its 131,072
    trades (block mode on that row, warp mode on the others; the plain
    version run over 2,048 key rows at a time).  Every row, the slab and
    [wake, missed] equal."""
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    from siddhi_tpu_torch.kernels import keyed_window as kw
    t0 = time.perf_counter()
    lim = ke.SORT_LIMIT
    nsym = max(keys // 8, 8)

    def ps(i, per, n):
        return lambda p: keyed_args(torch, np, dev, p,
                                    *per_symbol(np, rng, i, per, n))
    # sort(1) with 32 arrivals a key row: C + E = 33
    run(sort_ql(1, "kso33"), "kso33", kw.MODE_SORT,
        [(f"send {i}", ps(i, 32, nsym)) for i in range(3)])
    # sort(64) and sort(184) with 16 trades of each even symbol and one of
    # each odd one a send: full rows of C + E = 80 and 200 candidates
    # beside rows of a few, in the slots' order of first arrival
    two = np.where(np.arange(nsym) % 2 == 0, 16, 1)
    for c, qname in ((64, "kso80"), (184, "kso200")):
        n_fill = -(-c // 16)
        run(sort_ql(c, qname), qname, kw.MODE_SORT,
            [(f"send {i}", ps(i, two, nsym)) for i in range(n_fill + 2)],
            fill=range(n_fill))
    # KSO1 over 6 and 10 columns: 5 sends filling, 2 compared
    for nc in (6, 10):
        qname = f"ksoc{nc}"
        run(wide_ql(nc, qname), qname, kw.MODE_SORT,
            [(f"send {i}", lambda p, i=i, nc=nc: keyed_args(
                torch, np, dev, p, *wide_send(np, rng, i, nc, keys)))
             for i in range(7)], fill=range(5))
    # sort(SORT_LIMIT - 32) and sort(SORT_LIMIT - 31) with 32 arrivals a
    # key row: full slabs rank C + E = SORT_LIMIT (warp mode) and
    # SORT_LIMIT + 1 (block mode) candidates
    n_fill = (lim - 32) // 32 + 2
    for c, qname in ((lim - 32, "ksow"), (lim - 31, "ksob")):
        run(sort_ql(c, qname), qname, kw.MODE_SORT,
            [(f"send {i}", ps(i, 32, nsym // 2)) for i in range(n_fill)],
            fill=range(n_fill - 2))
    # the hot symbol
    plan = keyed_plan(dev, KSO1_QL.format(keys=keys), "kso1")
    slabs = [plan.init_state()[0]]
    for i in range(2):
        kx_fill(torch, plan, slabs, keyed_args(
            torch, np, dev, plan, *kso1_send(np, rng, 20 + i,
                                             KSO1_B * keys // KX_KEYS, keys)))
    slabs.append(slabs[0].clone())
    args = keyed_args(torch, np, dev, plan,
                      *kso1_hot_send(np, rng, 22, keys,
                                     KSO1_HOT * keys // KX_KEYS))
    timing["sort_block"] = (plan, slabs[0].clone(), tuple(args[:8]),
                            "hot send")
    e = kx_twin_rows(torch, plan, slabs, args, "phase 41 kso1 hot send",
                     stats)
    if e:
        fail(f"phase 41: K22 on the hot send differs ({e})")
    sp = ke.sort_plan(slabs[0].C, int(args[6].shape[1]), int(args[5].shape[0]))
    print(f"compare: K22 hot send == plain ({int(args[6].shape[1])} events "
          f"a key row, block mode {'on' if sp.block else 'off'}); K22's mode "
          f"edges took {time.perf_counter() - t0:.1f} s")
    del slabs, args
    torch.cuda.empty_cache()


def kx_bytes(torch, planned, before, after, args, n_out):
    """The bytes one K20-K23 step must move: each event read once (ts,
    kind, valid, slot, columns, its sel entry), each emitted row written
    once (ts, kind, seq, slot, columns), each slab row that leaves a
    stepped key read once and each row that enters written once, and each
    key row's index and counters read and written."""
    ts, kind, valid, gslot, cols, key_idx, sel, now = args
    cb = sum(c.element_size() for c in before.cols)
    live = key_idx < before.K
    ki = key_idx[live].long()

    def rows(s):
        n = s.count[ki].sum()
        if s.p_count is not None:
            n = n + s.p_count[ki].sum()
        return int(n)
    old, new = rows(before), rows(after)
    keep = planned.filter_spec
    from siddhi_tpu_torch.kernels import keyed_window as kw
    ok = kw._keep(keep, ts, kind, valid, cols, now)
    n_arr = int(ok[sel[(sel >= 0) & live[:, None]].long()].sum())
    leave = max(0, old + n_arr - new)
    enter = max(0, new - old + leave)
    n_read = int((sel >= 0).sum())
    kb = int(live.sum())
    return (n_read * (8 + 4 + 1 + 4 + 4 + cb) + n_out * (8 + 4 + 8 + 4 + cb)
            + (leave + enter) * (8 + 4 + cb) + kb * (4 + 2 * (4 + 4 + 8)))


def time_slice11(torch, np, dev, timing):
    """Phase 42: each mode of K20-K23 per launch (CUDA-graph replays from a
    restored slab) at its phase-41 step, beside the bound of the bytes the
    step must move and its plain version; for K22's warp mode (KSO1's
    steady send) also one batched torch.topk over the step's [Kb, C + E]
    candidate keys (the library call nearest to it: it ranks but does not
    evict, emit or move rows), and for its block mode (the hot send) one
    torch.sort(stable=True) of the hot key row's C + E keys."""
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    from siddhi_tpu_torch.kernels import sort_window as sw
    res = {}
    for mode, (plan, saved, args, label) in timing.items():
        slab = saved.clone()
        prm = kx_prm(plan)
        spec = plan.filter_spec

        def restore():
            slab.copy_from(saved)
        restore()
        n_out = int(ke.launch(slab, spec, *args, prm)[0].ts.shape[0])
        nbytes = kx_bytes(torch, plan, saved, slab, args, n_out)
        restore()
        ms = graph_ms(torch, lambda: ke.launch(slab, spec, *args, prm,
                                               n_out=n_out), 20, restore)
        if mode == "sort_block":
            plain = event_timer(torch, lambda: plain_by_rows(
                torch, plan, slab, args), 1, restore)
        else:
            plain = event_timer(torch, lambda: ke.plain(slab, spec, *args,
                                                        prm), 3, restore)
        kb = int(args[5].shape[0])
        r = {"ms": ms, "plain_ms": plain, **bound(nbytes),
             "shape": f"{plan.name} {label}: {kb} key rows x E = "
                      f"{int(args[6].shape[1])}, C = {saved.C}, {n_out} rows "
                      f"out", "library_ms": None}
        if mode in (ke.MODE_SORT, "sort_block"):
            sel = args[6]
            if mode == "sort_block":
                hot = int((sel >= 0).sum(1).argmax())
                ki, sel = args[5][hot:hot + 1].long(), sel[hot:hot + 1]
            else:
                ki = args[5].long().clamp(0, saved.K - 1)
            kc = torch.cat([saved.cols[prm.key_pos][ki],
                            args[4][prm.key_pos][sel.long().clamp(min=0)]], 1)
            keys = sw.sort_keys(kc, prm.desc)
            if mode == "sort_block":
                keys = keys[0].contiguous()
                r["library_ms"] = event_timer(
                    torch, lambda: torch.sort(keys, stable=True), 20)
                r["library"] = (f"torch.sort(stable=True) of the hot key "
                                f"row's {int(keys.shape[0])} int64 keys")
            else:
                r["library_ms"] = event_timer(
                    torch, lambda: torch.topk(keys, prm.length, dim=1,
                                              largest=False), 20)
                r["library"] = (f"torch.topk over [{kb}, "
                                f"{int(keys.shape[1])}] int64 keys")
        res[mode] = r
        del slab
    return res


def run_kx1(torch, np, dev, mods, keys=KX_KEYS):
    """KX1: externalTime(eventTime, 1 min) per device at 65,536 devices,
    two readings each a send (about 60 alive a device after 30 sends): 30
    filling, 16 timed, 2 checked row by row against KX1Model.  Returns
    K20's externalTime launches."""
    ke = mods["keyed_ext"]
    rng = np.random.default_rng(173)
    n = KX1_FILL + KX1_TIMED + KX1_CHECK
    sends = [kx1_send(np, rng, i, keys) for i in range(n + 4)]
    model = KX1Model(np, keys)
    counts, _, res = run9(
        torch, np, dev, mods, KX1_QL.format(keys=keys), "kx1",
        "SensorStream", sends, model, (KX1_FILL, KX1_CHECK, False),
        "KX1 (externalTime(1 min) per device, 65,536 devices)",
        KX1_TIMED * 2 * keys, 2 * keys * (8 + 8 + 4 + 8 + 4 + 1 + 4),
        ("keyed_ext", "group_agg"))
    k = counts["keyed_ext"][0][ke.MODE_EXT]
    print(f"KX1: sends {n - KX1_CHECK}-{n - 1} held row by row to the numpy "
          f"model (each device's EXPIRED rows at event time + 1 min and "
          f"CURRENT rows in key order, its running avg and count); rows "
          f"expiring a steady send {res[-1]}; K20 externalTime launches {k}")
    return k


def run_kxb1(torch, np, dev, mods, keys=KX_KEYS):
    """KXB1: externalTimeBatch(eventTime, 1 min) per device, device d's
    clock (d mod 30) s ahead: 30 filling, 16 timed, 2 checked (about 2,185
    devices flush a send, with the selector's RESET epochs).  Returns
    K21's externalTimeBatch launches."""
    ke = mods["keyed_ext"]
    rng = np.random.default_rng(175)
    n = KXB1_FILL + KXB1_TIMED + KXB1_CHECK
    sends = [kxb1_send(np, rng, i, keys) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, KXB1_QL.format(keys=keys), "kxb1",
        "SensorStream", sends, KXB1Model(np, keys),
        (KXB1_FILL, KXB1_CHECK, False),
        "KXB1 (externalTimeBatch(1 min) per device, 65,536 devices)",
        KXB1_TIMED * 2 * keys, 2 * keys * (8 + 8 + 4 + 8 + 4 + 1 + 4),
        ("keyed_ext", "group_agg"))
    k = counts["keyed_ext"][0][ke.MODE_XBATCH]
    print(f"KXB1: sends {n - KXB1_CHECK}-{n - 1} held row by row to the numpy "
          f"model (each flushing device's previous slice EXPIRED, its slice "
          f"CURRENT, the running avg and count across RESET epochs); devices "
          f"flushing a steady send {res[-1]}; K21 externalTimeBatch "
          f"launches {k}")
    return k


def run_kso1(torch, np, dev, mods, keys=KX_KEYS):
    """KSO1: sort(10, price, 'desc') per symbol at 65,536 symbols, 131,072
    trades a send: 8 filling, 2 checked, 16 timed.  Returns K22's
    launches."""
    ke = mods["keyed_ext"]
    rng = np.random.default_rng(177)
    n = KSO1_FILL + KSO1_CHECK + KSO1_TIMED
    b = KSO1_B * keys // KX_KEYS
    sends = [kso1_send(np, rng, i, b, keys) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, KSO1_QL.format(keys=keys), "kso1",
        "StockStream", sends, KSO1Model(np, keys),
        (KSO1_FILL, KSO1_CHECK, True),
        "KSO1 (sort(10, price, 'desc') per symbol, 65,536 symbols)",
        KSO1_TIMED * b, b * (8 + 4 + 4 + 8 + 4 + 1 + 4), ("keyed_ext",))
    k = counts["keyed_ext"][0][ke.MODE_SORT]
    print(f"KSO1: sends {KSO1_FILL}-{KSO1_FILL + KSO1_CHECK - 1} held row by "
          f"row to the numpy model; rows evicted a send {min(res[2:])}-"
          f"{max(res[2:])}; K22 launches {k}")
    return k


def run_khp1(torch, np, dev, mods, keys=KX_KEYS):
    """KHP1: hopping(1 min, 10 sec) per sensor at 65,536 sensors under
    playback, one reading a second each, two seconds a send: 12 filling,
    2 checked, 16 timed; each second's tick flushes about 6,554 sensors.
    Returns K23's launches (timer ticks included) and its ticks."""
    ke = mods["keyed_ext"]
    rng = np.random.default_rng(179)
    n = KHP1_FILL + KHP1_CHECK + KHP1_TIMED
    sends = [khp1_send(np, rng, i, keys) for i in range(n + 4)]
    model = KHP1Model(np, keys)
    counts, _, res = run9(
        torch, np, dev, mods, KHP1_QL.format(keys=keys), "khp1",
        "SensorStream", sends, model, (KHP1_FILL, KHP1_CHECK, True),
        "KHP1 (hopping(1 min, 10 sec) per sensor, 65,536 sensors)",
        KHP1_TIMED * 2 * keys, 2 * keys * (8 + 4 + 8 + 4 + 1 + 4),
        ("keyed_ext", "group_agg"))
    k = counts["keyed_ext"][0][ke.MODE_HOP]
    ticks = counts["keyed_ext"][1]
    print(f"KHP1: sends {KHP1_FILL}-{KHP1_FILL + KHP1_CHECK - 1} held row by "
          f"row to the numpy model (every tick's and data step's flushes, "
          f"the running avg across RESET epochs); sensors flushing a steady "
          f"send {res[-1]}; K23 launches {k} ({ticks} timer ticks)")
    return k, ticks


def kx_small_checks(np, mgr_fn):
    """KX1, KXB1, KSO1 and KHP1's models held to the port's rows at 64
    keys (the CPU tests run this on the plain versions)."""
    rng = np.random.default_rng(181)
    ok = []
    for ql, qname, stream, sends, model, fill in (
            (KX1_QL, "kx1", "SensorStream",
             [kx1_send(np, rng, i, 64) for i in range(36)],
             KX1Model(np, 64), 30),
            (KXB1_QL, "kxb1", "SensorStream",
             [kxb1_send(np, rng, i, 64) for i in range(36)],
             KXB1Model(np, 64), 30),
            (KSO1_QL, "kso1", "StockStream",
             [kso1_send(np, rng, i, 256, 64) for i in range(6)],
             KSO1Model(np, 64), 0),
            (KHP1_QL, "khp1", "SensorStream",
             [khp1_send(np, rng, i, 64) for i in range(12)],
             KHP1Model(np, 64), 6)):
        mgr = mgr_fn()
        rt = mgr.create_siddhi_app_runtime(ql.format(keys=64))
        got = []
        rt.add_batch_callback(qname, lambda ts, b: got.append(b))
        rt.start()
        h = rt.get_input_handler(stream)
        res = []
        for i, (cols, ts) in enumerate(sends):
            got.clear()
            h.send_columns(cols, timestamps=ts)
            res.append(model.step(cols, ts, list(got) if i >= fill else None,
                                  f"{qname} send {i}"))
        mgr.shutdown()
        ok.append(sum(res[fill:]))
    return ok


def slice11_phases(torch, np, dev):
    """Phases 41-44: K20-K23 against their plain versions; their times;
    KX1, KXB1, KSO1 and KHP1 through SiddhiManager; X3 (the JAX package's
    events of the keyed corpus).  Returns their kernel records."""
    from siddhi_tpu_torch.kernels import keyed_ext as ke
    mods = slice11_modules()
    t0 = time.perf_counter()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 11 {what}: {time.perf_counter() - t0:.1f} s")
    err, timing, _ = compare_keyed_ext(torch, np, dev)
    took("phase 41 done")
    res = time_slice11(torch, np, dev, timing)
    del timing
    took("phase 42 done")
    n = {ke.MODE_EXT: run_kx1(torch, np, dev, mods)}
    took("KX1 done")
    n[ke.MODE_XBATCH] = run_kxb1(torch, np, dev, mods)
    took("KXB1 done")
    n[ke.MODE_SORT] = run_kso1(torch, np, dev, mods)
    took("KSO1 done")
    n[ke.MODE_HOP], _ = run_khp1(torch, np, dev, mods)
    took("KHP1 done")
    launched = run_corpus(torch, np, dev, mods, "X3 (slice 11)", X11_CASES,
                          ("keyed_ext",))
    # the corpus is the main path of the modes no configuration drives
    for m in (ke.MODE_TLEN, ke.MODE_DELAY, ke.MODE_CHUNK, ke.MODE_CRON):
        n[m] = ke.mode_launches[m]
        if n[m] <= 0:
            fail(f"X3: K20-K23 mode {m} was never launched")
    print(f"X3: keyed_ext launches {launched['keyed_ext']} (by mode "
          f"{ke.mode_launches[6:]})")
    took("phase 44 done")
    no_lib = "no single PyTorch call computes a keyed window step"
    records = []
    for mode, name, kernel, rep in (
            (ke.MODE_EXT, "keyed_ext_externalTime", "K20", ":83"),
            (ke.MODE_TLEN, "keyed_ext_timeLength", "K20", ":279"),
            (ke.MODE_DELAY, "keyed_ext_delay", "K20", ":375"),
            (ke.MODE_XBATCH, "keyed_batch_externalTimeBatch", "K21", ":178"),
            (ke.MODE_CHUNK, "keyed_batch_batch", "K21", ":427"),
            (ke.MODE_CRON, "keyed_batch_cron", "K21", ":579"),
            (ke.MODE_SORT, "keyed_sort", "K22", ":496"),
            (ke.MODE_HOP, "keyed_hop", "K23", ":1166")):
        t = res[mode]
        lib = (f"library_ms {t['library_ms']:.4f} ({t['library']})"
               if t["library_ms"] is not None else f"library_ms null: {no_lib}")
        print(f"kernel {name} ({kernel}): {t['ms']:.4f} ms at {t['shape']} "
              f"(bound {t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} "
              f"bytes), plain {t['plain_ms']:.4f} ms, launches on the main "
              f"path {n[mode]}; {lib}")
        records.append({
            "name": name, "route": "cuda",
            "source": "siddhi_tpu_torch/csrc/keyed_ext.cu",
            "replaces": f"siddhi_tpu/core/window_ext.py{rep}",
            "launches": n[mode], "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if mode == ke.MODE_SORT:    # warp mode at KSO1, block mode hot
            b = res["sort_block"]
            print(f"kernel keyed_sort block mode: {b['ms']:.4f} ms at "
                  f"{b['shape']} (bound {b['bound_ms']:.5f} by "
                  f"{b['bound_by']}, {b['bytes']} bytes), plain "
                  f"{b['plain_ms']:.4f} ms; library_ms "
                  f"{b['library_ms']:.4f} ({b['library']})")
            records[-1]["modes"] = {
                md: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms")}
                for md, r in (("warp", t), ("block", b))}
    return records


# X3: the slice's corpus: each of the eight kinds inside a value partition
# with several keys a send, group by and having, a filter after the window,
# nulls, `insert all events` / `expired events`, range partitions, @purge
# and timer-driven cron / timeLength / delay / hopping keys.  _X11_WANT
# holds the JAX package's events (cron's with the JAX scheduler's timer
# entries deduplicated, as for X2); the CPU tests hold the cases to it
_KX = "@app:playback\ndefine stream S (k string, et long, v int);\n"


def _part(win, sel="k, v", extra="", key="k", ann="@capacity(keys='16')",
          out="insert all events into Out;", filt=""):
    return (_KX + f"partition with ({key} of S)\nbegin\n  {ann}\n"
            f"  @info(name='q') from S{filt}#window.{win}{extra}\n"
            f"  select {sel} {out}\nend;")


_EXT_SENDS = [("S", [["a", 1000, 1], ["b", 1000, 2], ["a", 1500, 3]], 1000),
              ("S", [["b", 1800, 4], ["a", 2200, 5]], 1100),
              ("S", [["a", 1900, 6], ["b", 3000, 7], ["c", 500, 8]], 1200),
              ("S", [["a", 4000, 9]], 1300)]
_T_SENDS = [("S", [["a", 0, 1], ["b", 0, 2]], 1000),
            ("S", [["a", 0, 3]], 1300),
            ("S", [["b", 0, 4], ["a", 0, 5], ["a", 0, 6]], 1700),
            ("S", [["c", 0, 7]], 2600), ("S", [["c", 0, 8]], 5000)]
_HOP_SENDS = [("S", [["a", 0, 1], ["b", 0, 2]], 1000),
              ("S", [["a", 0, 4]], 1500), ("S", [["b", 0, 8]], 2200),
              ("S", [["a", 0, 16], ["c", 0, 32]], 3100),
              ("S", [["c", 0, 64]], 4100), ("S", [["a", 0, 1]], 9000)]
_X11_SPECS = [
    ("keyed externalTime", _part("externalTime(et, 1000)",
                                 "k, v, sum(v) as total"), "q", _EXT_SENDS),
    ("keyed externalTime group by having",
     _part("externalTime(et, 1000)", "k, v, count() as n",
           out="group by v having n > 0 and v > 1 insert all events into "
               "Out;"),
     "q", _EXT_SENDS),
    ("keyed externalTime filter after the window",
     _part("externalTime(et, 1000)", "k, v, count() as n", extra="[v > 2]"),
     "q", _EXT_SENDS),
    ("keyed externalTime nulls", _part("externalTime(et, 1000)",
                                       "k, v, sum(v) as s"), "q",
     [("S", [["a", 1000, None], ["a", 1200, 2]], 1000),
      ("S", [["a", 2100, None], ["b", 100, None]], 1100)]),
    ("keyed timeLength", _part("timeLength(1 sec, 2)",
                               "k, v, count() as n"), "q", _T_SENDS),
    ("keyed delay", _part("delay(500)", "k, v, sum(v) as s"), "q", _T_SENDS),
    ("keyed externalTimeBatch", _part("externalTimeBatch(et, 1000)",
                                      "k, count() as n"), "q", _EXT_SENDS),
    ("keyed externalTimeBatch with start",
     _part("externalTimeBatch(et, 1000, 700)", "k, v, sum(v) as s"), "q",
     _EXT_SENDS),
    ("keyed batch", _part("batch()", "k, count() as n"), "q",
     [("S", [["a", 0, 1], ["b", 0, 2], ["a", 0, 3]], 1000),
      ("S", [["b", 0, 4]], 1100), ("S", [["a", 0, 5], ["b", 0, 6]], 1200)]),
    ("keyed cron", _part("cron('* * * * * ?')", "k, sum(v) as s"), "q",
     [("S", [["a", 0, 1], ["b", 0, 2]], 100),
      ("S", [["a", 0, 3]], 300), ("S", [["b", 0, 10]], 1200),
      ("S", [["c", 0, 5]], 2500), ("S", [["a", 0, 7]], 3600)]),
    ("keyed sort desc", _part("sort(2, v, 'desc')", "k, v"), "q",
     [("S", [["a", 0, 5], ["a", 0, 1], ["b", 0, 3], ["a", 0, 9]], 1000),
      ("S", [["b", 0, 7], ["b", 0, 1], ["a", 0, None]], 1100),
      ("S", [["b", 0, 8], ["a", 0, 2]], 1200)]),
    ("keyed sort asc group by", _part(
        "sort(2, v)", "k, v, count() as n",
        out="group by v insert all events into Out;"), "q",
     [("S", [["a", 0, 5], ["a", 0, 1], ["b", 0, 3], ["a", 0, 9]], 1000),
      ("S", [["b", 0, 7], ["b", 0, 1], ["a", 0, 0]], 1100)]),
    ("keyed hopping", _part("hopping(2 sec, 1 sec)", "k, count() as n"),
     "q", _HOP_SENDS),
    ("keyed hopping expired", _part("hopping(2 sec, 1 sec)", "k, v",
                                    out="insert expired events into Out;"),
     "q", _HOP_SENDS),
    ("range partition externalTime", _part(
        "externalTime(et, 1000)", "k, v, sum(v) as total",
        key="v < 5 as 'lo' or v >= 5 as 'hi'"), "q", _EXT_SENDS),
    ("range partition sort", _part(
        "sort(1, et)", "k, et, v", key="v < 5 as 'lo' or v >= 5 as 'hi'"),
     "q", _EXT_SENDS),
    ("purge timeLength", _part(
        "timeLength(2 sec, 3)", "k, v, count() as n",
        ann="@capacity(keys='4')\n  @purge(enable='true', interval='1 sec',"
            " idle.period='3 sec')"), "q",
     [("S", [["a", 0, 1], ["b", 0, 2], ["a", 0, 3]], 1000),
      ("S", [["c", 0, 3], ["d", 0, 4]], 8000),
      ("S", [["a", 0, 5], ["e", 0, 6]], 9000),
      ("S", [["a", 0, 7], ["e", 0, 8]], 9500)]),
    ("purge hopping", _part(
        "hopping(2 sec, 1 sec)", "k, v, count() as n",
        ann="@capacity(keys='4')\n  @purge(enable='true', interval='1 sec',"
            " idle.period='3 sec')"), "q",
     [("S", [["a", 0, 1], ["b", 0, 2]], 1000),
      ("S", [["c", 0, 3], ["d", 0, 4]], 8000),
      ("S", [["a", 0, 5], ["e", 0, 6]], 9000),
      ("S", [["a", 0, 7]], 12000)]),
]

_X11_WANT = [[(1000, [(1000, ('a', 1, 1)), (1000, ('a', 3, 4)), (1000, ('b', 2, 2))], []),
  (1100, [(1100, ('a', 5, 8)), (1100, ('b', 4, 6))], [(2000, ('a', 1, 3))]),
  (2000,
   [(1200, ('a', 6, 14)), (1200, ('b', 7, 7)), (1200, ('c', 8, 8))],
   [(2000, ('b', 2, 4)), (2800, ('b', 4, None))]),
  (2800,
   [(1300, ('a', 9, 9))],
   [(2500, ('a', 3, 11)), (2900, ('a', 6, 5)), (3200, ('a', 5, None))])],
 [(1000, [(1000, ('a', 3, 1)), (1000, ('b', 2, 1))], []),
  (1100, [(1100, ('a', 5, 1)), (1100, ('b', 4, 1))], []),
  (1200, [(1200, ('a', 6, 1)), (1200, ('b', 7, 1)), (1200, ('c', 8, 1))], []),
  (1300, [(1300, ('a', 9, 1))], [])],
 [(1000, [(1000, ('a', 3, 1))], []),
  (1100, [(1100, ('a', 5, 2)), (1100, ('b', 4, 1))], []),
  (1200,
   [(1200, ('a', 6, 3)), (1200, ('b', 7, 1)), (1200, ('c', 8, 1))],
   [(2800, ('b', 4, 0))]),
  (2800,
   [(1300, ('a', 9, 1))],
   [(2500, ('a', 3, 2)), (2900, ('a', 6, 1)), (3200, ('a', 5, 0))])],
 [(1000, [(1000, ('a', None, None)), (1000, ('a', 2, 2))], []),
  (1100,
   [(1100, ('a', None, 2)), (1100, ('b', None, None))],
   [(2000, ('a', None, 2))])],
 [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
  (1300, [(1300, ('a', 3, 2))], []),
  (1700,
   [(1700, ('a', 5, 1)), (1700, ('a', 6, 2)), (1700, ('b', 4, 2))],
   [(1700, ('a', 1, 1)), (1700, ('a', 3, 0))]),
  (2000, [], [(2000, ('b', 2, 1))]),
  (2600, [(2600, ('c', 7, 1))], []),
  (2700, [], [(2700, ('a', 5, 1)), (2700, ('a', 6, 0)), (2700, ('b', 4, 0))]),
  (3600, [], [(3600, ('c', 7, 0))]),
  (5000, [(5000, ('c', 8, 1))], [])],
 [(1500, [(1000, ('a', 1, 1)), (1000, ('b', 2, 2))], []),
  (1800, [(1300, ('a', 3, 4))], []),
  (2200,
   [(1700, ('a', 5, 9)), (1700, ('a', 6, 15)), (1700, ('b', 4, 6))],
   []),
  (3100, [(2600, ('c', 7, 7))], [])],
 [(1100, [(1000, ('a', 1)), (1000, ('a', 2))], []),
  (1200, [(1000, ('b', 1)), (1100, ('b', 2))], []),
  (1300,
   [(1100, ('a', 1)), (1200, ('a', 2))],
   [(1000, ('a', -1)), (1000, ('a', -2))])],
 [(1100, [(1000, ('a', 1, 1)), (1000, ('a', 3, 4)), (1000, ('b', 2, 2))], []),
  (1200, [(1100, ('b', 4, 4))], [(1000, ('b', 2, None))]),
  (1300,
   [(1100, ('a', 5, 5)), (1200, ('a', 6, 11))],
   [(1000, ('a', 1, -1)), (1000, ('a', 3, -4))])],
 [(1000, [(1000, ('a', 1)), (1000, ('a', 2)), (1000, ('b', 1))], []),
  (1100, [(1100, ('b', 1))], [(1000, ('b', 0))]),
  (1200,
   [(1200, ('a', 1)), (1200, ('b', 1))],
   [(1000, ('a', -1)), (1000, ('a', -2)), (1100, ('b', -1))])],
 [(1000, [(100, ('a', 1)), (300, ('a', 4)), (100, ('b', 2))], []),
  (2000,
   [(1200, ('b', 10))],
   [(100, ('a', -1)), (300, ('a', -4)), (100, ('b', -2))]),
  (3000, [(2500, ('c', 5))], [(1200, ('b', -10))])],
 [(1000,
   [(1000, ('a', 5)), (1000, ('a', 1)), (1000, ('a', 9)), (1000, ('b', 3))],
   [(1000, ('a', 1))]),
  (1100,
   [(1100, ('a', None)), (1100, ('b', 7)), (1100, ('b', 1))],
   [(1000, ('a', 5)), (1100, ('b', 1))]),
  (1200,
   [(1200, ('a', 2)), (1200, ('b', 8))],
   [(1200, ('a', 2)), (1000, ('b', 3))])],
 [(1000,
   [(1000, ('a', 5, 1)),
    (1000, ('a', 1, 1)),
    (1000, ('a', 9, 1)),
    (1000, ('b', 3, 1))],
   [(1000, ('a', 9, 0))]),
  (1100,
   [(1100, ('a', 0, 1)), (1100, ('b', 7, 1)), (1100, ('b', 1, 1))],
   [(1000, ('a', 5, 0)), (1100, ('b', 7, 0))])],
 [(2000, [(1000, ('a', 1)), (1500, ('a', 2)), (1000, ('b', 1))], []),
  (3000,
   [(1000, ('a', 1)), (1500, ('a', 2)), (1000, ('b', 1)), (2200, ('b', 2))],
   [(1000, ('a', -1)), (1500, ('a', -2)), (1000, ('b', -1))]),
  (4000,
   [(3100, ('a', 1)), (2200, ('b', 1))],
   [(1000, ('a', -1)),
    (1500, ('a', -2)),
    (1000, ('b', -1)),
    (2200, ('b', -2))]),
  (4100, [(3100, ('c', 1))], []),
  (5000, [(3100, ('a', 1))], [(3100, ('a', -1)), (2200, ('b', -1))]),
  (5100, [(3100, ('c', 1)), (4100, ('c', 2))], [(3100, ('c', -1))]),
  (6000, [], [(3100, ('a', -1))]),
  (6100, [(4100, ('c', 1))], [(3100, ('c', -1)), (4100, ('c', -2))]),
  (7100, [], [(4100, ('c', -1))])],
 [(2000, [(1000, ('a', 1)), (1500, ('a', 4)), (1000, ('b', 2))], []),
  (3000,
   [(1000, ('a', 1)), (1500, ('a', 4)), (1000, ('b', 2)), (2200, ('b', 8))],
   [(1000, ('a', 1)), (1500, ('a', 4)), (1000, ('b', 2))]),
  (4000,
   [(3100, ('a', 16)), (2200, ('b', 8))],
   [(1000, ('a', 1)), (1500, ('a', 4)), (1000, ('b', 2)), (2200, ('b', 8))]),
  (4100, [(3100, ('c', 32))], []),
  (5000, [(3100, ('a', 16))], [(3100, ('a', 16)), (2200, ('b', 8))]),
  (5100, [(3100, ('c', 32)), (4100, ('c', 64))], [(3100, ('c', 32))]),
  (6000, [], [(3100, ('a', 16))]),
  (6100, [(4100, ('c', 64))], [(3100, ('c', 32)), (4100, ('c', 64))]),
  (7100, [], [(4100, ('c', 64))])],
 [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 3)), (1000, ('a', 3, 6))], []),
  (1100, [(1100, ('b', 4, 10)), (1100, ('a', 5, 5))], []),
  (1200,
   [(1200, ('c', 8, 13)), (1200, ('a', 6, 11)), (1200, ('b', 7, 12))],
   [(1500, ('c', 8, 5)), (2900, ('a', 6, 5))]),
  (2900,
   [(1300, ('a', 9, 9))],
   [(3200, ('a', 5, 7)), (4000, ('b', 7, None))])],
 [(1000,
   [(1000, ('a', 1000, 1)), (1000, ('b', 1000, 2)), (1000, ('a', 1500, 3))],
   [(1000, ('b', 1000, 2)), (1000, ('a', 1500, 3))]),
  (1100,
   [(1100, ('b', 1800, 4)), (1100, ('a', 2200, 5))],
   [(1100, ('b', 1800, 4))]),
  (1200,
   [(1200, ('a', 1900, 6)), (1200, ('b', 3000, 7)), (1200, ('c', 500, 8))],
   [(1100, ('a', 2200, 5)), (1200, ('a', 1900, 6)), (1200, ('b', 3000, 7))]),
  (1300, [(1300, ('a', 4000, 9))], [(1300, ('a', 4000, 9))])],
 [(1000, [(1000, ('a', 1, 1)), (1000, ('a', 3, 2)), (1000, ('b', 2, 1))], []),
  (3000, [], [(3000, ('a', 1, 1)), (3000, ('a', 3, 0)), (3000, ('b', 2, 0))]),
  (8000, [(8000, ('d', 4, 1)), (8000, ('c', 3, 1))], []),
  (9000, [(9000, ('a', 5, 1)), (9000, ('e', 6, 1))], []),
  (9500, [(9500, ('a', 7, 2)), (9500, ('e', 8, 2))], [])],
 [(2000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
  (3000,
   [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))],
   [(1000, ('a', 1, -1)), (1000, ('b', 2, -1))]),
  (4000, [], [(1000, ('a', 1, -1)), (1000, ('b', 2, -1))]),
  (9000, [(8000, ('d', 4, 1)), (8000, ('c', 3, 1))], []),
  (10000,
   [(8000, ('d', 4, 1)),
    (8000, ('c', 3, 1)),
    (9000, ('a', 5, 1)),
    (9000, ('e', 6, 1))],
   [(8000, ('d', 4, -1)), (8000, ('c', 3, -1))]),
  (11000,
   [(9000, ('a', 5, 1)), (9000, ('e', 6, 1))],
   [(8000, ('d', 4, -1)),
    (8000, ('c', 3, -1)),
    (9000, ('a', 5, -1)),
    (9000, ('e', 6, -1))]),
  (12000, [], [(9000, ('a', 5, -1)), (9000, ('e', 6, -1))])]]
X11_CASES = [spec + (want,) for spec, want in zip(_X11_SPECS, _X11_WANT)]



# ---------------------------------------------------------------------------
# slice 12: keyed frequent / lossyFrequent (K24) and the expression windows
# at the top level and per key (K25, K26)
# ---------------------------------------------------------------------------

KF_KEYS = 1 << 16          # KFQ1's merchants, KEB1's meters
KFQ1_B = 1 << 17           # purchases a send
KFQ1_CARDS = 64            # a merchant's cards, drawn Zipf(1.1)
KFQ1_FILL, KFQ1_TIMED, KFQ1_CHECK = 8, 16, 2
EW1_B = 1 << 17            # trades a send
EW1_FILL, EW1_TIMED, EW1_CHECK = 8, 16, 2
EW1_C = 2048               # the default @capacity(window)
KEB1_FILL, KEB1_TIMED, KEB1_CHECK = 24, 16, 2
KEB1_C = 128

# the Siddhi API reference's PotentialFraud query (lossyFrequent(0.1,
# 0.01, cardNo)), kept per merchant: 10 counters a merchant
KFQ1_QL = """
@app:playback
define stream PurchaseStream (merchant long, cardNo long, price float);
partition with (merchant of PurchaseStream)
begin
  @capacity(keys='{keys}')
  @info(name='kfq1')
  from PurchaseStream#window.lossyFrequent(0.1, 0.01, cardNo)
  select merchant, cardNo, price insert all events into PotentialFraud;
end;
"""
# trades held while their volume sums under 100,000 within a minute
EW1_QL = """
@app:playback
define stream TradeStream (symbol long, price float, volume int);
@info(name='ew1')
from TradeStream#window.expression(
  'sum(volume) < 100000 and eventTimestamp(last) - eventTimestamp(first) < 60000')
select symbol, price, volume insert all events into Windowed;
"""
# a bill per meter, cut when its energy reaches 10 kWh (the reading that
# reaches it joins the bill)
KEB1_QL = """
@app:playback
define stream MeterStream (meter long, kwh float);
partition with (meter of MeterStream)
begin
  @capacity(keys='{keys}', window='128')
  @info(name='keb1')
  from MeterStream#window.expressionBatch('sum(kwh) < 10.0', true)
  select meter, kwh insert all events into Bills;
end;
"""


def slice12_modules():
    from siddhi_tpu_torch.kernels import expr_window, keyed_freq
    return {"keyed_freq": keyed_freq, "expr_window": expr_window}


def kfq1_send(np, rng, i, b=KFQ1_B, keys=KF_KEYS):
    """KFQ1's send i: b purchases, merchants uniform, each merchant's card
    drawn Zipf(1.1) from its 64 (card id merchant * 64 + rank), prices in
    cents below 500, at EX_T0 + 1 s * i (a ms apart in batch order)."""
    r = np.arange(1, KFQ1_CARDS + 1, dtype=np.float64) ** -1.1
    m = rng.integers(0, keys, b).astype(np.int64)
    card = m * KFQ1_CARDS + rng.choice(KFQ1_CARDS, b, p=r / r.sum())
    return ([m, card.astype(np.int64),
             (rng.integers(100, 50_000, b) / 100).astype(np.float32)],
            EX_T0 + 1000 * i + np.arange(b, dtype=np.int64) * 1000 // b)


def ew1_send(np, rng, i, b=EW1_B):
    """EW1's send i: b trades over a second (ts nondecreasing), symbols
    of 512, volume uniform 1-200, every 8th send 61 s after the one
    before."""
    t = EX_T0 + 1000 * i + 61_000 * (i // 8)
    return ([rng.integers(0, 512, b).astype(np.int64),
             (rng.integers(1000, 20_000, b) / 100).astype(np.float32),
             rng.integers(1, 201, b).astype(np.int32)],
            t + np.arange(b, dtype=np.int64) * 1000 // b)


def keb1_send(np, rng, i, keys=KF_KEYS):
    """KEB1's send i: two readings of every meter, in a random order (a
    meter's first before its second), kwh uniform 0.1-1.0, at EX_T0 +
    1 s * i."""
    p = rng.permutation(2 * keys)
    meter = (p % keys).astype(np.int64)       # reading p // keys of meter
    return ([meter, (0.1 + 0.9 * rng.random(2 * keys)).astype(np.float32)],
            np.full(2 * keys, EX_T0 + 1000 * i, np.int64))


def rank_in_key(np, key):
    """Each row's rank among its key's rows (batch order)."""
    o = np.argsort(key, kind="stable")
    k = key[o]
    start = np.r_[0, np.nonzero(k[1:] != k[:-1])[0] + 1] if k.size else \
        np.zeros(0, np.int64)
    r = np.empty(key.shape[0], np.int64)
    r[o] = np.arange(k.shape[0]) - np.repeat(start, np.diff(np.r_[start,
                                                                  k.size]))
    return r


class KFQ1Model:
    """KFQ1's counters in numpy: per merchant 10 (Misra-Gries, as the
    reference's FrequentWindow): a purchase whose card a counter holds
    adds one to it, the stored purchase EXPIRED and the new one stored; a
    free counter (the lowest) takes a new card; else every count drops by
    one, the counters reaching 0 EXPIRED in counter order, and the
    purchase is not emitted.  A stored purchase comes out with the new
    purchase's ts.  A checked step holds every row, merchant by merchant
    (kind, ts, card, price)."""

    def __init__(self, np, keys, n=10):
        self.np, self.n = np, n
        self.cnt = np.zeros((keys, n), np.int64)
        self.card = np.zeros((keys, n), np.int64)
        self.price = np.zeros((keys, n), np.float32)

    def step(self, cols, ts, batches, what):
        np, n = self.np, self.n
        m, card, price = cols
        rank = rank_in_key(np, m)
        R = int(rank.max()) + 1 if rank.size else 0
        K = self.cnt.shape[0]
        W = n + 1                      # a purchase's rows: n EXPIRED, CURRENT
        ex = np.zeros((K, R * W), np.bool_)
        kind = np.zeros((K, R * W), np.int32)
        tss = np.zeros((K, R * W), np.int64)
        cc = np.zeros((K, R * W), np.int64)
        pp = np.zeros((K, R * W), np.float32)
        jj = np.arange(n)[None, :]
        evicted = 0
        for r in range(R):
            at = np.nonzero(rank == r)[0]
            k, c, p, t = m[at], card[at], price[at], ts[at]
            cnt, held = self.cnt[k], self.card[k]
            match = (cnt > 0) & (held == c[:, None])
            hit = match.any(1)
            free = cnt == 0
            slot = np.where(hit, match.argmax(1), free.argmax(1))
            miss = ~hit & ~free.any(1)
            out = np.where(miss[:, None], cnt == 1,
                           hit[:, None] & (jj == slot[:, None]))
            lo = r * W
            ex[k, lo:lo + n] = out
            kind[k, lo:lo + n] = 1
            tss[k, lo:lo + n] = t[:, None]
            cc[k, lo:lo + n] = held
            pp[k, lo:lo + n] = self.price[k]
            ex[k, lo + n] = ~miss
            tss[k, lo + n], cc[k, lo + n], pp[k, lo + n] = t, c, p
            evicted += int((miss[:, None] & out).sum())
            # the counters move
            put = ~miss
            cnt = np.where(miss[:, None], cnt - 1, cnt)
            ks, sl = k[put], slot[put]
            cnt[put, sl] = np.where(hit[put], cnt[put, sl] + 1, 1)
            self.cnt[k] = cnt
            self.card[ks, sl] = c[put]
            self.price[ks, sl] = p[put]
        if batches is not None:
            keys, lens, flat = masked_rows(np, np.arange(K), ex, kind, tss,
                                           cc, pp)
            check_keyed(np, what, batches, ("merchant", "cardNo", "price"),
                        (keys, lens, *flat), None, False)
        return evicted


class EW1Model:
    """EW1's window in numpy: the trades held are a suffix of the stream;
    each arrival's front is the first held trade from which the volume
    sum to the arrival is under 100,000 and the arrival is less than a
    minute later (both hold for every later start, so the first is found
    by a binary search), at least the arrival's index + 1 - C; the trades
    the front passes come out EXPIRED with their own ts before the
    arrival's CURRENT row.  A checked step holds every row in order."""

    def __init__(self, np, C=EW1_C):
        self.np, self.C = np, C
        self.ts = np.zeros(0, np.int64)
        self.cols = [np.zeros(0, np.int64), np.zeros(0, np.float32),
                     np.zeros(0, np.int32)]

    def step(self, cols, ts, batches, what):
        np = self.np
        cnt, B = self.ts.shape[0], ts.shape[0]
        cts = np.r_[self.ts, ts]
        cc = [np.r_[a, b] for a, b in zip(self.cols, cols)]
        vol = cc[2].astype(np.int64)
        P = np.cumsum(vol)
        hi = cnt + np.arange(B)
        j_sum = np.searchsorted(P - vol, P[hi] - 100_000, side="right")
        j_ts = np.searchsorted(cts, cts[hi] - 60_000, side="right")
        front = np.maximum.accumulate(np.maximum(np.maximum(j_sum, j_ts),
                                                 hi + 1 - self.C))
        ff = int(front[-1]) if B else 0
        p = np.arange(ff)
        kp = np.searchsorted(front, p, side="right")
        n = ff + B
        order = np.empty(n, np.int64)
        order[p + kp] = p
        order[front + np.arange(B)] = hi
        kind = np.zeros(n, np.int32)
        kind[p + kp] = 1
        if batches is not None:
            g_kind, g_ts, g = sent_rows(np, batches,
                                        ("symbol", "price", "volume"))
            expect(np, what, "kind", g_kind, kind)
            expect(np, what, "ts", g_ts, cts[order])
            for name, c in zip(("symbol", "price", "volume"), cc):
                expect(np, what, name, g[name], c[order])
        self.ts = cts[ff:]
        self.cols = [c[ff:] for c in cc]
        return ff


class KEB1Model:
    """KEB1's bills in numpy: per meter its pending readings and their
    exact float64 sum; a reading that brings the sum to 10 kWh or more
    cuts the bill (pending and the reading) CURRENT, after the previous
    bill EXPIRED, and the bill becomes the previous one.  A checked step
    holds every row, meter by meter (kind, ts, kwh)."""

    def __init__(self, np, keys, C=KEB1_C):
        self.np, self.C = np, C
        self.pend = np.zeros((keys, C), np.float32)
        self.pend_ts = np.zeros((keys, C), np.int64)
        self.n = np.zeros(keys, np.int64)
        self.sum = np.zeros(keys, np.float64)
        self.prev = np.zeros((keys, C + 1), np.float32)
        self.prev_ts = np.zeros((keys, C + 1), np.int64)
        self.pn = np.zeros(keys, np.int64)

    def step(self, cols, ts, batches, what):
        np, C = self.np, self.C
        m, kwh = cols
        rank = rank_in_key(np, m)
        K = self.n.shape[0]
        W = 2 * (C + 1)                # a meter's rows: EXPIRED, then CURRENT
        ex = np.zeros((K, W), np.bool_)
        kind = np.zeros((K, W), np.int32)
        tss = np.zeros((K, W), np.int64)
        val = np.zeros((K, W), np.float32)
        flushed = np.zeros(K, np.bool_)
        ar = np.arange(C + 1)[None, :]
        for r in range(int(rank.max()) + 1 if rank.size else 0):
            at = np.nonzero(rank == r)[0]
            k, x, t = m[at], kwh[at], ts[at]
            s = self.sum[k] + x.astype(np.float64)
            cut = ~(s < 10.0)
            if (cut & flushed[k]).any() or (self.n[k] >= C).any():
                fail(f"{what}: KEB1 cuts a bill twice in a send or runs "
                     f"past its capacity")
            kc = k[cut]
            pn, n = self.pn[kc], self.n[kc]
            # the previous bill EXPIRED, then the pending readings and the
            # reading CURRENT
            ex[kc, :C + 1] = ar < pn[:, None]
            kind[kc, :C + 1] = 1
            tss[kc, :C + 1] = self.prev_ts[kc]
            val[kc, :C + 1] = self.prev[kc]
            bill = np.c_[self.pend[kc], np.zeros(kc.shape[0], np.float32)]
            bts = np.c_[self.pend_ts[kc], np.zeros(kc.shape[0], np.int64)]
            bill[np.arange(kc.shape[0]), n] = x[cut]
            bts[np.arange(kc.shape[0]), n] = t[cut]
            ex[kc, C + 1:] = ar < (n + 1)[:, None]
            tss[kc, C + 1:] = bts
            val[kc, C + 1:] = bill
            self.prev[kc], self.prev_ts[kc], self.pn[kc] = bill, bts, n + 1
            self.n[kc], self.sum[kc] = 0, 0.0
            flushed[kc] = True
            kk = k[~cut]
            self.pend[kk, self.n[kk]] = x[~cut]
            self.pend_ts[kk, self.n[kk]] = t[~cut]
            self.n[kk] += 1
            self.sum[kk] = s[~cut]
        if batches is not None:
            keys, lens, flat = masked_rows(np, np.arange(K), ex, kind, tss,
                                           val)
            check_keyed(np, what, batches, ("meter", "kwh"),
                        (keys, lens, *flat), None, False)
        return int(flushed.sum())


def kf_small_checks(np, mgr_fn):
    """KFQ1, EW1 and KEB1's models held to the port's rows at a small size
    (64 keys; the CPU tests run this on the plain versions)."""
    rng = np.random.default_rng(191)
    ok = []
    for ql, qname, stream, sends, model, fill in (
            (KFQ1_QL, "kfq1", "PurchaseStream",
             [kfq1_send(np, rng, i, 1024, 64) for i in range(8)],
             KFQ1Model(np, 64), 2),
            (EW1_QL, "ew1", "TradeStream",
             [ew1_send(np, rng, i, 700) for i in range(10)],
             EW1Model(np), 2),
            (KEB1_QL, "keb1", "MeterStream",
             [keb1_send(np, rng, i, 64) for i in range(30)],
             KEB1Model(np, 64), 4)):
        mgr = mgr_fn()
        rt = mgr.create_siddhi_app_runtime(ql.format(keys=64))
        got = []
        rt.add_batch_callback(qname, lambda ts, b: got.append(b))
        rt.start()
        h = rt.get_input_handler(stream)
        res = []
        for i, (cols, ts) in enumerate(sends):
            got.clear()
            h.send_columns(cols, timestamps=ts)
            res.append(model.step(cols, ts, list(got) if i >= fill else None,
                                  f"{qname} send {i}"))
        mgr.shutdown()
        ok.append(sum(res[fill:]))
    return ok


def s12_twin(torch, planned, mod, slabs, args, what, stats):
    """One K24-K26 step on slabs[0] and its plain version on slabs[1]:
    every emitted row and the whole slab compared (exact)."""
    prm = kx_prm(planned)
    spec = planned.filter_spec
    args = tuple(args[:8])
    ra, wa = mod.launch(slabs[0], spec, *args, prm)
    rb, wb = mod.plain(slabs[1], spec, *args, prm)
    torch.cuda.synchronize()
    err = rows_err(torch, ra, rb, what, full=True)
    err = max(err, float_err(torch, wa, wb, f"{what} wake"),
              slab_err(torch, slabs[0], slabs[1], what))
    stats["steps"] += 1
    stats["rows"] += int(ra.ts.shape[0])
    stats["pads"] += int((args[5] >= slabs[0].K).sum())
    return err


def s12_hot(torch, planned, mod, slabs, args, what, stats):
    """One K25 / K26 step whose widest key row is one hot key's (its key
    in column 0): the kernel over every key row on slabs[0]; the plain
    version on slabs[1] over the hot key row alone (the same E: its rows
    and state exact) and over the other key rows at their own width, 8,192
    at a time (rows and state exact but for seq, which hangs on E)."""
    from siddhi_tpu_torch.core.window import Rows
    prm = kx_prm(planned)
    spec = planned.filter_spec
    ts, kind, valid, gslot, cols, key_idx, sel, now = args[:8]
    width = (sel >= 0).sum(1)
    p = int(width.argmax())
    rest = torch.ones_like(width, dtype=torch.bool)
    rest[p] = False
    e2 = max(int(width[rest].max()), 1)
    ra, _ = mod.launch(slabs[0], spec, *args[:8], prm)
    rh, _ = mod.plain(slabs[1], spec, ts, kind, valid, gslot, cols,
                      key_idx[p:p + 1].contiguous(),
                      sel[p:p + 1].contiguous(), now, prm)
    others = torch.nonzero(rest).squeeze(1)
    parts = []
    for i0 in range(0, int(others.shape[0]), 8192):
        r = others[i0:i0 + 8192]
        parts.append(mod.plain(slabs[1], spec, ts, kind, valid, gslot, cols,
                               key_idx[r].contiguous(),
                               sel[r][:, :e2].contiguous(), now, prm)[0])
    torch.cuda.synchronize()
    is_hot = ra.cols[0] == cols[0][sel[p, 0].long()]

    def sub(r, m, seq=True):
        return Rows(ts=r.ts[m], kind=r.kind[m], valid=r.valid[m],
                    seq=r.seq[m] if seq else torch.zeros_like(r.seq[m]),
                    gslot=r.gslot[m], cols=tuple(c[m] for c in r.cols))
    ro = Rows(*(torch.cat([getattr(x, f) for x in parts])
                for f in ("ts", "kind", "valid", "seq", "gslot")),
              cols=tuple(torch.cat(c) for c in zip(*(x.cols for x in parts))))
    err = rows_err(torch, sub(ra, is_hot), rh, f"{what} hot key", full=True)
    err = max(err, rows_err(
        torch, sub(ra, ~is_hot, False),
        sub(ro, torch.ones_like(ro.valid), False), f"{what} other keys",
        full=True))
    la, lb = slabs[0].logical(), slabs[1].logical()
    k = int(key_idx[p])
    for name in la:
        x, y = la[name], lb[name]
        if name == "seq":
            x, y = x[k:k + 1], y[k:k + 1]
        if not same_bits(torch, x, y):
            err = max(err, float_err(torch, x, y, f"{what} slab {name}"))
    stats["steps"] += 1
    stats["rows"] += int(ra.ts.shape[0])
    return err


def s12_scratch(planned, C, args):
    """K25 / K26's scratch bytes at these arguments, and what a [Kb, E]
    layout (every key row as wide as the widest) would take."""
    prm = kx_prm(planned)
    B, (Kb, E) = int(args[0].shape[0]), tuple(args[6].shape)
    nw = (C + (0 if prm.batch else 1) + 31) // 32
    lanes = len(prm.program.lanes) + 2 * len(prm.program.aggs)
    return ((lanes * (Kb * C + B) * 8 + B * (nw * 4 + 8 + 4) + Kb * E * 4),
            (lanes * Kb * (C + E) * 8 + Kb * E * (nw * 4 + 8 + 4)))


def top_args(torch, np, dev, planned, cols, ts):
    """A top-level window's step arguments: the staged send on one key
    row whose events are the whole batch."""
    from siddhi_tpu_torch.core import event as ev
    b = stage(np, ev, cols, ts).to_device(planned.in_schema, dev)
    B = b.ts.shape[0]
    return (b.ts, b.kind, b.valid, torch.zeros(B, dtype=torch.int32,
                                               device=dev), b.cols,
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.arange(B, dtype=torch.int32, device=dev).view(1, B),
            int(np.asarray(ts).max()))


def top_plan(dev, ql, qname):
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    return rt.query_runtimes[qname].planned


def compare_slice12(torch, np, dev, keys=KF_KEYS):
    """Phase 45: K24, K25 and K26 against their plain versions, step by
    step, exact: every row and every key's state.  K24 at KFQ1 (65,536
    merchants: 2 sends from empty, 6 filling, 2 steady, a send from part
    of the merchants: padding key rows) and frequent(4, price) with -0.0,
    +0.0 and NaN prices; K25 per meter at KEB1's traffic (sum, and the
    clamp at j = hi - C) and at the top level on one key row of 131,072
    trades (EW1 from empty, filled, across a 61 s jump; a NaN price; the
    clamp); K26 per meter (KEB1; a meter of 300 readings in a send: runs
    above C) and at the top level with stream.current.event and with
    include.triggering.event; K24 at KFQ1 with its counters in the global
    workspace; K25 and K26 at C = 2,048 with one hot meter of 13,000
    readings among 65,536 (s12_hot).  Returns (max error, timing inputs,
    stats)."""
    mods = slice12_modules()
    rng = np.random.default_rng(193)
    stats = {"steps": 0, "rows": 0, "pads": 0}
    timing, err = {}, 0.0

    def run(ql, qname, mod, steps, fill=(), time_as=None, top=False):
        nonlocal err
        plan = (top_plan if top else keyed_plan)(dev, ql, qname)
        slab = plan.init_state()[0]
        slabs = [slab, slab.clone()]
        for j, (label, mk) in enumerate(steps):
            args = mk(plan)
            if j in fill:
                mod.launch(slabs[0], plan.filter_spec, *tuple(args[:8]),
                           kx_prm(plan))
                if j + 1 not in fill:
                    slabs[1] = slabs[0].clone()
                continue
            if time_as is not None and label == time_as[1]:
                timing[time_as[0]] = (plan, mod, slabs[0].clone(),
                                      tuple(args[:8]), label)
            err = max(err, s12_twin(torch, plan, mod, slabs, args,
                                    f"phase 45 {qname} {label}", stats))

    def send(fn, i, *a):
        return lambda p: keyed_args(torch, np, dev, p, *fn(np, rng, i, *a))

    def top(fn, i, *a):
        return lambda p: top_args(torch, np, dev, p, *fn(np, rng, i, *a))

    part = max(keys // 20 + 3, 3)
    kf, ew = mods["keyed_freq"], mods["expr_window"]
    # K24 at KFQ1
    steps = [(f"send {i}", send(kfq1_send, i, KFQ1_B * keys // KF_KEYS,
                                keys)) for i in range(10)]
    steps.append(("partial send", send(kfq1_send, 10, part, part)))
    run(KFQ1_QL.format(keys=keys), "kfq1", kf, steps, fill=range(2, 8),
        time_as=("K24", "send 9"))

    def odd(i):
        def mk(p):
            cols, ts = kfq1_send(np, rng, i, 4 * keys, keys)
            x = rng.random(cols[2].shape[0])
            cols[2] = np.where(x < 0.3, -0.0, np.where(
                x < 0.6, 0.0, np.where(x < 0.8, np.nan, 1.5))) \
                .astype(np.float32)
            return keyed_args(torch, np, dev, p, cols, ts)
        return mk
    ql = KFQ1_QL.format(keys=keys).replace(
        "lossyFrequent(0.1, 0.01, cardNo)", "frequent(4, price)") \
        .replace("'kfq1'", "'kfq2'")
    run(ql, "kfq2", kf, [(f"-0.0 / NaN send {i}", odd(i)) for i in range(3)])
    # K24 with every key row's counters in the global workspace (the
    # shared memory cap set to 0): 1,024 blocks stride over the key rows
    smem = kf.SMEM_MAX
    kf.SMEM_MAX = 0
    try:
        run(KFQ1_QL.format(keys=keys).replace("'kfq1'", "'kfg'"), "kfg", kf,
            [(f"global workspace send {i}",
              send(kfq1_send, i, KFQ1_B * keys // KF_KEYS, keys))
             for i in range(3)])
    finally:
        kf.SMEM_MAX = smem
    # K25 per meter at KEB1's traffic, and the clamp case
    # (the clamp: a key's front row always has kwh < 0.5, so once it holds
    # C + 1 rows the expression holds at j = hi - C, and the front moves
    # to hi + 1 - C before it looks for the next such row)
    for win, qname, n_fill in (("expression('sum(kwh) < 10.0')", "kew", 20),
                               ("expression('first.kwh < 0.5')", "kcl", 62)):
        ql = KEB1_QL.format(keys=keys).replace(
            "expressionBatch('sum(kwh) < 10.0', true)", win) \
            .replace("'keb1'", f"'{qname}'")
        steps = [(f"send {i}", send(keb1_send, i, keys))
                 for i in range(n_fill + 4)]
        steps.append(("partial send", send(keb1_send, n_fill + 4, part)))
        run(ql, qname, ew, steps, fill=range(2, n_fill + 2),
            time_as=("K25 keyed", f"send {n_fill + 2}")
            if qname == "kew" else None)
    # K26 per meter (KEB1), a meter of 300 readings (runs above C)
    steps = [(f"send {i}", send(keb1_send, i, keys)) for i in range(26)]

    def hot(p):
        cols, ts = keb1_send(np, rng, 26, keys)
        cols = [np.r_[cols[0], np.full(300, 5, np.int64)],
                np.r_[cols[1], np.full(300, 0.125, np.float32)]]
        return keyed_args(torch, np, dev, p, cols,
                          np.r_[ts, np.full(300, ts[0])])
    steps += [("a meter of 300 readings", hot),
              ("partial send", send(keb1_send, 27, part))]
    run(KEB1_QL.format(keys=keys), "keb1", ew, steps, fill=range(2, 24),
        time_as=("K26", "send 25"))
    # K25 at the top level: EW1 from empty, filled, across the jump at 8
    steps = [(f"send {i}", top(ew1_send, i)) for i in range(10)]

    def nan_send(p):
        cols, ts = ew1_send(np, rng, 10)
        cols[1][rng.random(cols[1].shape[0]) < 0.001] = np.nan
        return top_args(torch, np, dev, p, cols, ts)
    run(EW1_QL, "ew1", ew, steps, fill=range(1, 6), top=True,
        time_as=("K25", "send 7"))
    ql = EW1_QL.replace("sum(volume) < 100000", "sum(price) < 90000.0") \
        .replace("'ew1'", "'ewn'")
    run(ql, "ewn", ew, [("send 0", top(ew1_send, 0)), ("NaN send", nan_send)],
        top=True)
    # the clamp at the top level: the front row's price is below 100, the
    # window grows to C + 1 rows and the clamp moves the front
    ql = EW1_QL.replace(
        "'sum(volume) < 100000 and eventTimestamp(last) - "
        "eventTimestamp(first) < 60000'", "'first.price < 100.0'") \
        .replace("'ew1'", "'ewc'")
    run(ql, "ewc", ew, [(f"send {i}", top(ew1_send, i)) for i in range(2)],
        top=True)
    # K26 at the top level, both batch options
    for opts, qname in (("false, true", "ebs"), ("true", "ebi")):
        ql = EW1_QL.replace(
            "expression(\n  'sum(volume) < 100000 and eventTimestamp(last) - "
            "eventTimestamp(first) < 60000')",
            f"expressionBatch('sum(volume) < 100000', {opts})") \
            .replace("'ew1'", f"'{qname}'")
        run(ql, qname, ew, [(f"send {i}", top(ew1_send, i))
                            for i in range(3)], top=True)
    # one hot meter among 65,536 at C = 2,048: 13,000 of its readings
    # beside every meter's two (the scratch is sized by the arrivals)
    for win, qname in (("expression('sum(kwh) < 100.0')", "khw"),
                       ("expressionBatch('sum(kwh) < 100.0', true)", "khb")):
        ql = KEB1_QL.format(keys=keys).replace(
            "expressionBatch('sum(kwh) < 10.0', true)", win) \
            .replace("window='128'", "window='2048'") \
            .replace("'keb1'", f"'{qname}'")
        plan = keyed_plan(dev, ql, qname)
        slab = plan.init_state()[0]
        slabs = [slab, slab.clone()]
        for i in range(2):
            cols, ts = keb1_send(np, rng, i, keys)
            cols = [np.r_[cols[0], np.full(13_000, 5, np.int64)],
                    np.r_[cols[1], (0.1 + 0.9 * rng.random(13_000))
                          .astype(np.float32)]]
            args = keyed_args(torch, np, dev, plan, cols,
                              np.r_[ts, np.full(13_000, ts[0])])
            if i == 0:
                have, dense = s12_scratch(plan, slab.C, args)
                print(f"phase 45 {qname}: {int(args[5].shape[0])} key rows "
                      f"x E = {int(args[6].shape[1])}, C = {slab.C}: "
                      f"scratch {have} bytes (a [Kb, E] layout: {dense})")
            err = max(err, s12_hot(torch, plan, ew, slabs, args,
                                   f"phase 45 {qname} hot send {i}", stats))
        del slab, slabs, args
        torch.cuda.empty_cache()
    if not stats["pads"]:
        fail("phase 45: no padding key rows were compared")
    print(f"phase 45 K24-K26: {stats['steps']} steps, {stats['rows']} rows "
          f"equal to the plain versions ({stats['pads']} padding key rows), "
          f"max_abs_err {err}")
    return err, timing, stats


def s12_bytes(torch, planned, before, after, args, n_out):
    """The bytes one K24-K26 step must move: each event read once (ts,
    kind, valid, slot, columns, its sel entry), each emitted row written
    once, each stepped key row's index and counters read and written; and
    of each stepped key's state only what the step reads or changes:
      K24: its counts and key words read; the stored events that leave (a
        counter hit, replaced or evicted) read; the counts, key words and
        stored events that change written;
      K25 / K26: the lanes the range program reads of the kept (pending)
        rows that stay, the kept rows that leave read, the arrivals that
        stay written; K26 also a flushing key's previous batch read and
        its new one written.
    No scratch.  The timed queries have no filter: a key row's arrivals
    are its sel entries that are valid CURRENT rows."""
    from siddhi_tpu_torch.core import event as ev
    ts, kind, valid, gslot, cols, key_idx, sel, now = args
    cb = sum(c.element_size() for c in before.cols)
    row = 8 + 4 + cb                       # a stored row: ts, slot, columns
    live = key_idx < before.K
    at = sel.clamp(min=0).long()
    na = ((sel >= 0) & valid[at] & (kind[at] == ev.CURRENT)).sum(1)
    ki = key_idx[live & (na > 0)].long()
    na = na[live & (na > 0)]
    kb = int(ki.shape[0])

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    if before.f_counts is not None:
        n, nk = before.C, before.f_keys.shape[2]
        cb0, ca = before.f_counts[ki], after.f_counts[ki]
        kchg = (before.f_keys[ki] != after.f_keys[ki]).any(-1)
        schg = (before.ts[ki] != after.ts[ki]) | \
            (before.gslot[ki] != after.gslot[ki])
        for x, y in zip(before.cols, after.cols):
            schg |= bits(x[ki]) != bits(y[ki])
        leave = (cb0 > 0) & ((ca == 0) | schg | kchg)
        enter = (ca > 0) & ((cb0 == 0) | schg | kchg)
        state = (kb * n * (8 + 8 * nk) + int(leave.sum()) * row +
                 int(enter.sum()) * row + int((cb0 != ca).sum()) * 8 +
                 int(kchg.sum()) * 8 * nk)
        head = kb * (4 + 2 * 8)            # key_idx; seq read and written
    else:
        prog = kx_prm(planned).program
        lane = sum(8 if pos < 0 else before.cols[pos].element_size()
                   for pos in prog.lanes)
        c0 = before.count[ki].long()
        c1 = after.count[ki].long()
        front = c0 + na - c1               # K25's front, K26's start
        leave = torch.minimum(front, c0).clamp(min=0)
        enter = c1 - (c0 - leave)
        state = (int((c0 - leave).sum()) * lane + int(leave.sum()) * row +
                 int(enter.sum()) * row)
        if before.p_count is not None:
            p0 = before.p_count[ki].long()
            p1 = after.p_count[ki].long()
            fl = (front > 0) | (p0 != p1)
            state += (int(p0[fl].sum()) + int(p1[fl].sum())) * row
            head = kb * (4 + 2 * (4 + 4 + 8))   # count, p_count, seq
        else:
            head = kb * (4 + 2 * (4 + 8))       # count, seq
    n_read = int((sel >= 0).sum())
    return (n_read * (8 + 4 + 1 + 4 + 4 + cb) + n_out * (8 + 4 + 8 + 4 + cb)
            + state + head)


def time_slice12(torch, np, dev, timing):
    """Phase 46: K24 (KFQ1's step), K25 (EW1's step at the top level and
    KEB1's traffic per meter) and K26 (KEB1's step) per launch, replayed
    from a CUDA graph from a restored slab, beside the bound of the bytes
    the step must move and the plain version's time."""
    res = {}
    for name, (plan, mod, saved, args, label) in timing.items():
        slab = saved.clone()
        prm = kx_prm(plan)
        spec = plan.filter_spec

        def restore():
            slab.copy_from(saved)
        restore()
        n_out = int(mod.launch(slab, spec, *args, prm)[0].ts.shape[0])
        nbytes = s12_bytes(torch, plan, saved, slab, args, n_out)
        restore()
        ms = graph_ms(torch, lambda: mod.launch(slab, spec, *args, prm,
                                                n_out=n_out), 10, restore)
        plain = event_timer(torch, lambda: mod.plain(slab, spec, *args, prm),
                            2, restore)
        res[name] = {"ms": ms, "plain_ms": plain, **bound(nbytes),
                     "shape": f"{plan.name} {label}: {int(args[5].shape[0])} "
                              f"key rows x E = {int(args[6].shape[1])}, C = "
                              f"{saved.C}, {n_out} rows out",
                     "library_ms": None}
        del slab
    return res


def fq1_on_k24(torch, np, dev):
    """Phase 46b: FQ1's step (1,000 counters, one key) through K24 on a
    one-key MODE_FREQ slab beside K19, from the same state (two sends in):
    the rows and the counters equal (exact), and both timed (CUDA-graph
    replays).  K24 walks the arrivals twice (count, write), K19 once into
    an output sized by its bound."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.kernels import frequent as fq
    from siddhi_tpu_torch.kernels import keyed_freq as kf
    from siddhi_tpu_torch.kernels.keyed_window import MODE_FREQ, KeyedSlab
    rng = np.random.default_rng(157)
    plan = window_plan(dev, FQ1_QL, "fq1")
    kp = tuple(plan.window.key_positions)
    st = plan.init_state()[0]
    for i in range(2):
        arr, n, _, _ = window_args(torch, np, dev, plan, *fq1_send(np, rng, i))
        fq.launch(st, arr, n, kp)
    arr, n, now, _ = window_args(torch, np, dev, plan, *fq1_send(np, rng, 2))
    na, A, N = int(n), int(arr.ts.shape[0]), st.n
    slab = KeyedSlab.empty(MODE_FREQ, plan.window.schema.types, 1, N, dev,
                           nkeys=len(kp))
    slab.f_counts[0], slab.f_keys[0] = st.counts, st.keys
    slab.ts[0], slab.gslot[0] = st.ts, st.gslot
    for x, y in zip(slab.cols, st.cols):
        x[0] = y
    slab.seq[0] = st.meta[0]
    sel = torch.full((1, A), -1, dtype=torch.int32, device=dev)
    sel[0, arr.seq[:na]] = torch.arange(na, dtype=torch.int32, device=dev)
    args = (arr.ts, torch.full((A,), ev.CURRENT, dtype=torch.int32,
                               device=dev),
            torch.arange(A, device=dev) < na, arr.gslot, arr.cols,
            torch.zeros(1, dtype=torch.int32, device=dev), sel, now)
    prm = kf.FreqParams(N, kp)
    spec = plan.filter_spec          # FQ1's filter: every arrival passes
    st0, slab0 = st.clone(), slab.clone()
    r19 = fq.launch(st, arr, n, kp)
    r24, _ = kf.launch(slab, spec, *args, prm)
    torch.cuda.synchronize()
    what = "phase 46b FQ1 on K24"
    err = rows_err(torch, r24, r19, what, full=True)
    live = st.counts > 0
    err = max(err, float_err(torch, slab.f_counts[0], st.counts,
                             f"{what} counts"),
              float_err(torch, slab.seq[:1], st.meta[:1], f"{what} seq"))
    for x, y in ((slab.f_keys[0], st.keys), (slab.ts[0], st.ts),
                 (slab.gslot[0], st.gslot),
                 *((x[0], y) for x, y in zip(slab.cols, st.cols))):
        err = max(err, float_err(torch, x[live], y[live], f"{what} state"))
    m = int(r19.ts.shape[0])
    t19 = graph_ms(torch, lambda: fq.launch(st, arr, n, kp, n_out=m), 3,
                   lambda: st.copy_from(st0))
    t24 = graph_ms(torch, lambda: kf.launch(slab, spec, *args, prm,
                                            n_out=m), 3,
                   lambda: slab.copy_from(slab0))
    print(f"phase 46b: FQ1's step ({na} arrivals, {N} counters, {m} rows "
          f"out) on one key row: K24 {t24:.4f} ms, K19 {t19:.4f} ms "
          f"({t24 / t19:.3f}x); rows and counters equal, max_abs_err {err}")
    return {"k24_ms": t24, "k19_ms": t19, "err": err}


def run_kfq1(torch, np, dev, mods, keys=KF_KEYS):
    """KFQ1: lossyFrequent(0.1, 0.01, cardNo) per merchant at 65,536
    merchants, 131,072 purchases a send: 8 filling, 16 timed, 2 checked
    row by row against KFQ1Model.  Returns K24's launches."""
    rng = np.random.default_rng(195)
    n = KFQ1_FILL + KFQ1_TIMED + KFQ1_CHECK
    sends = [kfq1_send(np, rng, i, KFQ1_B, keys) for i in range(n + 4)]
    _, launches, res = run9(
        torch, np, dev, mods, KFQ1_QL.format(keys=keys), "kfq1",
        "PurchaseStream", sends, KFQ1Model(np, keys),
        (KFQ1_FILL, KFQ1_CHECK, False),
        "KFQ1 (lossyFrequent(0.1, 0.01, cardNo) per merchant, 65,536 "
        "merchants)", KFQ1_TIMED * KFQ1_B, KFQ1_B * (8 + 8 + 4 + 8 + 4 + 1),
        ("keyed_freq",))
    print(f"KFQ1: sends {n - KFQ1_CHECK}-{n - 1} held row by row to the "
          f"numpy model (each merchant's replaced and evicted purchases "
          f"EXPIRED, its new ones CURRENT); counters evicted a steady send "
          f"{res[-1]}; K24 launches {launches['keyed_freq']}")
    return launches["keyed_freq"]


def run_ew1(torch, np, dev, mods):
    """EW1: the top-level expression window over 131,072 trades a send (a
    window of about 1,000 trades by volume, every 8th send 61 s later: it
    empties): 8 filling, 16 timed, 2 checked (the first across a jump)
    row by row against EW1Model.  Returns K25's launches."""
    ew = mods["expr_window"]
    rng = np.random.default_rng(197)
    n = EW1_FILL + EW1_TIMED + EW1_CHECK
    sends = [ew1_send(np, rng, i) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, EW1_QL, "ew1", "TradeStream", sends,
        EW1Model(np), (EW1_FILL, EW1_CHECK, False),
        "EW1 (expression(sum(volume) < 100000 and 1 min), 131,072 trades a "
        "send)", EW1_TIMED * EW1_B, EW1_B * (8 + 8 + 4 + 4 + 8 + 4 + 1),
        ("expr_window",))
    k = counts["expr_window"][0][ew.MODE_EXPR]
    print(f"EW1: sends {n - EW1_CHECK}-{n - 1} held row by row to the numpy "
          f"model (every EXPIRED trade before the arrival that passes it, "
          f"the jump emptying the window); trades expiring a send "
          f"{min(res[1:])}-{max(res[1:])}; K25 launches {k}")
    return k


def run_keb1(torch, np, dev, mods, keys=KF_KEYS):
    """KEB1: expressionBatch('sum(kwh) < 10.0', true) per meter at 65,536
    meters, two readings a meter a send: 24 filling, 16 timed, 2 checked
    row by row against KEB1Model.  Returns K26's launches."""
    ew = mods["expr_window"]
    rng = np.random.default_rng(199)
    n = KEB1_FILL + KEB1_TIMED + KEB1_CHECK
    sends = [keb1_send(np, rng, i, keys) for i in range(n + 4)]
    counts, _, res = run9(
        torch, np, dev, mods, KEB1_QL.format(keys=keys), "keb1",
        "MeterStream", sends, KEB1Model(np, keys),
        (KEB1_FILL, KEB1_CHECK, False),
        "KEB1 (expressionBatch(sum(kwh) < 10.0, true) per meter, 65,536 "
        "meters)", KEB1_TIMED * 2 * keys, 2 * keys * (8 + 8 + 4 + 8 + 4 + 1),
        ("expr_window",))
    k = counts["expr_window"][0][ew.MODE_EXPRB]
    print(f"KEB1: sends {n - KEB1_CHECK}-{n - 1} held row by row to the "
          f"numpy model (each cut bill CURRENT after the previous one "
          f"EXPIRED); meters billed a steady send {res[-1]}; K26 launches "
          f"{k}")
    return k


def slice12_phases(torch, np, dev):
    """Phases 45-48: K24-K26 against their plain versions; their times;
    KFQ1, EW1 and KEB1 through SiddhiManager; X4 (the JAX package's events
    of the slice's corpus).  Returns their kernel records."""
    from siddhi_tpu_torch.kernels import expr_window as ew
    mods = slice12_modules()
    t0 = time.perf_counter()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 12 {what}: {time.perf_counter() - t0:.1f} s")
    err, timing, _ = compare_slice12(torch, np, dev)
    took("phase 45 done")
    res = time_slice12(torch, np, dev, timing)
    del timing
    err = max(err, fq1_on_k24(torch, np, dev)["err"])
    took("phase 46 done")
    n = {"K24": run_kfq1(torch, np, dev, mods)}
    took("KFQ1 done")
    n["K25"] = run_ew1(torch, np, dev, mods)
    took("EW1 done")
    n["K26"] = run_keb1(torch, np, dev, mods)
    took("KEB1 done")
    launched = run_corpus(torch, np, dev, mods, "X4 (slice 12)", X12_CASES,
                          ("keyed_freq", "expr_window"))
    print(f"X4: keyed_freq launches {launched['keyed_freq']}, expr_window "
          f"launches {launched['expr_window']} (by mode "
          f"{ew.mode_launches[ew.MODE_EXPR:]})")
    took("phase 48 done")
    no_lib = "no single PyTorch call computes these window steps"
    records = []
    for key, name, src, rep in (
            ("K24", "keyed_freq", "keyed_freq.cu",
             "siddhi_tpu/core/window_ext.py:1023"),
            ("K25", "expr_window", "expr_window.cu",
             "siddhi_tpu/core/window_expr.py:227"),
            ("K26", "expr_batch", "expr_window.cu",
             "siddhi_tpu/core/window_expr.py:329")):
        t = res[key]
        print(f"kernel {name} ({key}): {t['ms']:.4f} ms at {t['shape']} "
              f"(bound {t['bound_ms']:.5f} by {t['bound_by']}, {t['bytes']} "
              f"bytes), plain {t['plain_ms']:.4f} ms, launches on the main "
              f"path {n[key]}; library_ms null: {no_lib}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n[key], "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    t = res["K25 keyed"]
    print(f"kernel expr_window per key (K25): {t['ms']:.4f} ms at "
          f"{t['shape']} (bound {t['bound_ms']:.5f} by {t['bound_by']}, "
          f"{t['bytes']} bytes), plain {t['plain_ms']:.4f} ms")
    return records


# X4: the slice's corpus: the expression windows at the top level, in a
# value partition and in a range partition (test_window_expr.py's six
# apps, aggregates, first / last / eventTimestamp, % on negatives, a weak
# constant at an f32 boundary, the clamp at hi - C, a run above C, both
# batch options, a NaN row), and keyed frequent / lossyFrequent (-0.0 and
# NaN keys, every column as the key, @purge).  _X12_WANT holds the JAX
# package's events; the CPU tests hold the cases to it
_XS = "@app:playback\ndefine stream S (sym string, price float, v int);\n"
_XW = [("S", ["A", 1.0, 1], 1000), ("S", ["B", 2.0, -2], 1001),
       ("S", ["C", 3.0, 3], 1002), ("S", ["D", 4.0, -4], 1003),
       ("S", ["E", 5.0, 5], 1004)]
_XSYM = [("S", [["X", 1.0, 1], ["X", 2.0, -2]], 1000),
         ("S", [["Y", 3.0, 3], ["Y", 4.0, -4]], 1001),
         ("S", [["Z", 5.0, 5]], 1002)]
_XSUM = [("S", [["A", 60.0, 1]], 1000), ("S", [["B", 30.0, -2]], 1001),
         ("S", [["C", 50.0, 3], ["A", 9.5, 4]], 1002),
         ("S", [["B", 45.0, -5], ["C", None, 6]], 1003),
         ("S", [["A", 20.0, 7], ["B", 2.5, -8]], 1004),
         ("S", [["C", 99.0, 9]], 1005)]
_XMIX = [("S", [["a", 7.5, -7], ["b", -2.5, 5], ["a", 3.25, 2]], 1000),
         ("S", [["b", 8.0, -1], ["a", -6.5, 4]], 1001),
         ("S", [["a", 1.0, -9], ["b", 0.5, 3], ["b", 12.0, 8]], 1003),
         ("S", [["a", 100.1, 6], ["b", 100.1, -6]], 1004),
         ("S", [["a", 2.0, 1], ["b", -0.0, 0], ["a", 5.5, -3]], 1006),
         ("S", [["b", 4.0, 2], ["a", 9.0, 11]], 1007)]


def _xwin(win, sel="sym, price, v", out="insert all events into Out;",
          cap="", where="top"):
    """A window query at the top level, in a value partition (by sym) or
    in a range partition (on v)."""
    ann = f"@capacity(window='{cap}') " if cap else ""
    q = f"@info(name='q') from S#window.{win} select {sel} {out}"
    if where == "top":
        return _XS + ann + q
    key = "sym" if where == "value" else \
        "v < 0 as 'neg' or v >= 0 as 'pos'"
    return (_XS + f"partition with ({key} of S)\nbegin\n  {ann}{q}\nend;")


_X12_BASE = [
    ("count <= 2", "expression('count() <= 2')", {}, _XW),
    ("sum eviction", "expression('sum(price) < 100.0')", {}, _XSUM),
    ("running aggregate", "expression('count() <= 3')",
     dict(sel="sum(price) as total", out="insert into Out;"), _XW),
    ("batch count", "expressionBatch('count() <= 2')",
     dict(out="insert into Out;"), _XW),
    ("batch symbol change", "expressionBatch('last.sym == first.sym')",
     dict(out="insert into Out;"), _XSYM),
    ("batch expired replay", "expressionBatch('count() <= 2')", {}, _XW),
    ("aggregates", "expression('avg(price) > first.price - 5.0 and "
                   "max(v) - min(v) <= 9')", {}, _XMIX),
    ("first last timestamps",
     "expression('eventTimestamp(last) - eventTimestamp(first) < 3 and "
     "last.v >= first.v - 12')", {}, _XMIX),
    ("mod on negatives", "expression('sum(v % -3) > -4 and "
                         "(last.price % -2.5) > -2.0')", {}, _XMIX),
    ("weak float at an f32 boundary",
     "expression('last.price < 100.1 and first.price != 100.1')", {},
     _XMIX),
    ("clamp at hi - C", "expression('first.price == 7.5')", dict(cap="3"),
     _XMIX),
    ("run above C", "expressionBatch('count() <= 10')", dict(cap="3"),
     _XMIX),
    ("include trigger", "expressionBatch('sum(price) < 10.0', true)", {},
     _XMIX),
    ("stream current", "expressionBatch('sum(price) < 10.0', false, true)",
     {}, _XMIX),
    ("include and stream", "expressionBatch('count() <= 2', true, true)",
     {}, _XMIX),
    ("NaN row", "expression('sum(price) < 100.0')",
     dict(sel="sym, price, count() as n"), _XSUM),
]
_XF = "@app:playback\ndefine stream S (m string, card long, price float);\n"
_XF_SENDS = [("S", [["a", 1, 1.0], ["a", 2, -0.0], ["b", 1, 0.0],
                    ["a", 1, 2.0]], 1000),
             ("S", [["a", 3, None], ["b", 2, 1.5], ["a", 3, None],
                    ["b", 1, -0.0]], 1001),
             ("S", [["a", 4, 0.0], ["c", 9, 9.0], ["a", 2, -0.0]], 1002),
             ("S", [["b", 5, 2.5], ["a", 1, 3.0], ["c", 9, None]], 1003)]


def _xf(win, key="m", ann="@capacity(keys='16')"):
    return (_XF + f"partition with ({key} of S)\nbegin\n  {ann}\n"
            f"  @info(name='q') from S#window.{win}\n"
            f"  select m, card, price, count() as n insert all events into "
            f"Out;\nend;")


_X12_SPECS = [
    (f"{where} {name}", _xwin(win, where=where, **kw), "q", sends)
    for name, win, kw, sends in _X12_BASE
    for where in ("top", "value", "range")] + [
    ("keyed frequent every column", _xf("frequent(2)"), "q", _XF_SENDS),
    ("keyed frequent one card", _xf("frequent(1, card)"), "q", _XF_SENDS),
    ("keyed frequent -0.0 and NaN keys", _xf("frequent(2, price)"), "q",
     _XF_SENDS),
    ("keyed lossyFrequent", _xf("lossyFrequent(0.5, 0.1, card)"), "q",
     _XF_SENDS),
    ("range partition lossyFrequent",
     _xf("lossyFrequent(0.34, card)",
         key="card < 3 as 'lo' or card >= 3 as 'hi'"), "q", _XF_SENDS),
    ("purge frequent", _xf(
        "frequent(2, card)", ann="@capacity(keys='4')\n  @purge(enable="
        "'true', interval='1 sec', idle.period='3 sec')"), "q",
     [("S", [["a", 1, 1.0], ["b", 2, 2.0], ["a", 3, 3.0]], 1000),
      ("S", [["c", 3, 3.0], ["d", 4, 4.0]], 8000),
      ("S", [["a", 5, 5.0], ["e", 6, 6.0], ["a", 1, 1.0]], 9000),
      ("S", [["a", 7, 7.0], ["e", 6, 8.0]], 9500)]),
]

_X12_WANT = [[(1000, [(1000, ('A', 1.0, 1))], []),
  (1001, [(1001, ('B', 2.0, -2))], []),
  (1002, [(1002, ('C', 3.0, 3))], [(1000, ('A', 1.0, 1))]),
  (1003, [(1003, ('D', 4.0, -4))], [(1001, ('B', 2.0, -2))]),
  (1004, [(1004, ('E', 5.0, 5))], [(1002, ('C', 3.0, 3))])],
 [(1000, [(1000, ('A', 1.0, 1))], []),
  (1001, [(1001, ('B', 2.0, -2))], []),
  (1002, [(1002, ('C', 3.0, 3))], []),
  (1003, [(1003, ('D', 4.0, -4))], []),
  (1004, [(1004, ('E', 5.0, 5))], [])],
 [(1000, [(1000, ('A', 1.0, 1))], []),
  (1001, [(1001, ('B', 2.0, -2))], []),
  (1002, [(1002, ('C', 3.0, 3))], []),
  (1003, [(1003, ('D', 4.0, -4))], []),
  (1004, [(1004, ('E', 5.0, 5))], [(1000, ('A', 1.0, 1))])],
 [(1000, [(1000, ('A', 60.0, 1))], []),
  (1001, [(1001, ('B', 30.0, -2))], []),
  (1002,
   [(1002, ('C', 50.0, 3)), (1002, ('A', 9.5, 4))],
   [(1000, ('A', 60.0, 1))]),
  (1003,
   [(1003, ('B', 45.0, -5)), (1003, ('C', None, 6))],
   [(1001, ('B', 30.0, -2)),
    (1002, ('C', 50.0, 3)),
    (1002, ('A', 9.5, 4)),
    (1003, ('B', 45.0, -5)),
    (1003, ('C', None, 6))]),
  (1004, [(1004, ('A', 20.0, 7)), (1004, ('B', 2.5, -8))], []),
  (1005,
   [(1005, ('C', 99.0, 9))],
   [(1004, ('A', 20.0, 7)), (1004, ('B', 2.5, -8))])],
 [(1000, [(1000, ('A', 60.0, 1))], []),
  (1001, [(1001, ('B', 30.0, -2))], []),
  (1002, [(1002, ('A', 9.5, 4)), (1002, ('C', 50.0, 3))], []),
  (1003,
   [(1003, ('B', 45.0, -5)), (1003, ('C', None, 6))],
   [(1002, ('C', 50.0, 3)), (1003, ('C', None, 6))]),
  (1004, [(1004, ('A', 20.0, 7)), (1004, ('B', 2.5, -8))], []),
  (1005, [(1005, ('C', 99.0, 9))], [])],
 [(1000, [(1000, ('A', 60.0, 1))], []),
  (1001, [(1001, ('B', 30.0, -2))], []),
  (1002,
   [(1002, ('C', 50.0, 3)), (1002, ('A', 9.5, 4))],
   [(1000, ('A', 60.0, 1))]),
  (1003,
   [(1003, ('C', None, 6)), (1003, ('B', 45.0, -5))],
   [(1002, ('C', 50.0, 3)), (1002, ('A', 9.5, 4)), (1003, ('C', None, 6))]),
  (1004, [(1004, ('A', 20.0, 7)), (1004, ('B', 2.5, -8))], []),
  (1005, [(1005, ('C', 99.0, 9))], [(1004, ('A', 20.0, 7))])],
 [(1000, [(1000, (1.0,))], []),
  (1001, [(1001, (3.0,))], []),
  (1002, [(1002, (6.0,))], []),
  (1003, [(1003, (9.0,))], [(1000, (5.0,))]),
  (1004, [(1004, (12.0,))], [(1001, (7.0,))])],
 [(1000, [(1000, (1.0,))], []),
  (1001, [(1001, (2.0,))], []),
  (1002, [(1002, (3.0,))], []),
  (1003, [(1003, (4.0,))], []),
  (1004, [(1004, (5.0,))], [])],
 [(1000, [(1000, (1.0,))], []),
  (1001, [(1001, (2.0,))], []),
  (1002, [(1002, (4.0,))], []),
  (1003, [(1003, (6.0,))], []),
  (1004, [(1004, (9.0,))], [])],
 [(1002, [(1000, ('A', 1.0, 1)), (1001, ('B', 2.0, -2))], []),
  (1004,
   [(1002, ('C', 3.0, 3)), (1003, ('D', 4.0, -4))],
   [(1000, ('A', 1.0, 1)), (1001, ('B', 2.0, -2))])],
 [],
 [(1004, [(1000, ('A', 1.0, 1)), (1002, ('C', 3.0, 3))], [])],
 [(1001, [(1000, ('X', 1.0, 1)), (1000, ('X', 2.0, -2))], []),
  (1002,
   [(1001, ('Y', 3.0, 3)), (1001, ('Y', 4.0, -4))],
   [(1000, ('X', 1.0, 1)), (1000, ('X', 2.0, -2))])],
 [],
 [(1001, [(1000, ('X', 1.0, 1)), (1000, ('X', 2.0, -2))], []),
  (1002, [(1001, ('Y', 3.0, 3))], [(1000, ('X', 1.0, 1))])],
 [(1002, [(1000, ('A', 1.0, 1)), (1001, ('B', 2.0, -2))], []),
  (1004,
   [(1002, ('C', 3.0, 3)), (1003, ('D', 4.0, -4))],
   [(1000, ('A', 1.0, 1)), (1001, ('B', 2.0, -2))])],
 [],
 [(1004, [(1000, ('A', 1.0, 1)), (1002, ('C', 3.0, 3))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   [(1000, ('a', 7.5, -7))]),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('b', 8.0, -1)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   [(1004, ('b', 100.0999984741211, -6))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   []),
  (1001,
   [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))],
   [(1000, ('a', 7.5, -7))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 3.25, 2)), (1001, ('a', -6.5, 4))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1003, ('a', 1.0, -9)),
    (1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   [(1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1007,
   [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))],
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   []),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   []),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6)),
    (1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   []),
  (1001, [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1000, ('b', -2.5, 5))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1001, ('b', 8.0, -1))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))]),
  (1007,
   [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))],
   [(1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))]),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))]),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1004, ('a', 100.0999984741211, 6))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001,
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('b', 8.0, -1))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1001, ('a', -6.5, 4)), (1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))]),
  (1007, [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   []),
  (1001,
   [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))],
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1001, ('b', 8.0, -1))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1003, ('b', 0.5, 3))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1004, ('a', 100.0999984741211, 6)),
    (1003, ('b', 12.0, 8)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3))]),
  (1007, [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001,
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))],
   [(1000, ('a', 7.5, -7)), (1001, ('b', 8.0, -1)), (1000, ('b', -2.5, 5))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 3.25, 2)), (1001, ('a', -6.5, 4)), (1003, ('b', 0.5, 3))]),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   [(1003, ('a', 1.0, -9)),
    (1004, ('b', 100.0999984741211, -6)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))]),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   [(1006, ('a', 5.5, -3))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1006, ('a', 2.0, 1))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('b', 8.0, -1)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   []),
  (1007, [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   []),
  (1001, [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1004, ('a', 100.0999984741211, 6)),
    (1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   []),
  (1007, [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   [(1000, ('a', 7.5, -7)),
    (1001, ('b', 8.0, -1)),
    (1003, ('a', 1.0, -9)),
    (1004, ('b', 100.0999984741211, -6)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))]),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   []),
  (1007, [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001,
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('b', 8.0, -1)),
    (1001, ('a', -6.5, 4))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   [(1000, ('b', -2.5, 5))]),
  (1001,
   [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))],
   [(1001, ('b', 8.0, -1))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 7.5, -7)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))]),
  (1007,
   [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))],
   [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   [(1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))]),
  (1001,
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))],
   [(1001, ('a', -6.5, 4))]),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))]),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   [(1000, ('a', 7.5, -7)), (1004, ('a', 100.0999984741211, 6))]),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   [(1001, ('b', 8.0, -1)),
    (1003, ('a', 1.0, -9)),
    (1004, ('b', 100.0999984741211, -6)),
    (1006, ('a', 5.5, -3)),
    (1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))])],
 [(1001,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1003,
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4)), (1003, ('a', 1.0, -9))],
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))]),
  (1004,
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))],
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4)), (1003, ('a', 1.0, -9))]),
  (1006,
   [(1004, ('b', 100.0999984741211, -6)),
    (1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0))],
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))])],
 [(1003,
   [(1000, ('a', 7.5, -7)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3))],
   []),
  (1006,
   [(1003, ('a', 1.0, -9)),
    (1004, ('a', 100.0999984741211, 6)),
    (1006, ('a', 2.0, 1))],
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1001, ('a', -6.5, 4))]),
  (1007,
   [(1003, ('b', 12.0, 8)),
    (1004, ('b', 100.0999984741211, -6)),
    (1006, ('b', -0.0, 0))],
   [(1000, ('b', -2.5, 5)), (1001, ('b', 8.0, -1)), (1003, ('b', 0.5, 3))])],
 [(1003,
   [(1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2)), (1001, ('a', -6.5, 4))],
   []),
  (1004,
   [(1000, ('a', 7.5, -7)), (1001, ('b', 8.0, -1)), (1003, ('a', 1.0, -9))],
   []),
  (1006,
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))],
   [(1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2)), (1001, ('a', -6.5, 4))]),
  (1007,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1007, ('b', 4.0, 2))],
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))])],
 [(1001,
   [(1000, ('a', 7.5, -7)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('b', 8.0, -1))],
   []),
  (1004,
   [(1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('b', 8.0, -1)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))]),
  (1007,
   [(1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0)),
    (1006, ('a', 5.5, -3)),
    (1007, ('b', 4.0, 2))],
   [(1004, ('b', 100.0999984741211, -6))])],
 [(1000, [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2))], []),
  (1003,
   [(1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1004, ('a', 100.0999984741211, 6)),
    (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('a', 3.25, 2)),
    (1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8))]),
  (1007,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1007, ('a', 9.0, 11))],
   [(1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1004, ('a', 100.0999984741211, 6))])],
 [(1001, [(1000, ('a', 7.5, -7)), (1001, ('b', 8.0, -1))], []),
  (1004,
   [(1003, ('a', 1.0, -9)),
    (1004, ('b', 100.0999984741211, -6)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))],
   [(1000, ('a', 7.5, -7)), (1001, ('b', 8.0, -1))]),
  (1007,
   [(1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0)),
    (1007, ('b', 4.0, 2)),
    (1007, ('a', 9.0, 11))],
   [(1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1001, ('b', 8.0, -1)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   [(1004, ('a', 100.0999984741211, 6))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1004, ('b', 100.0999984741211, -6)),
    (1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0)),
    (1006, ('a', 5.5, -3))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   []),
  (1001, [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   [(1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('a', 1.0, -9)),
    (1003, ('b', 12.0, 8))]),
  (1007,
   [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))],
   [(1004, ('a', 100.0999984741211, 6))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   [(1000, ('a', 7.5, -7))]),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   [(1001, ('b', 8.0, -1)),
    (1003, ('a', 1.0, -9)),
    (1000, ('b', -2.5, 5)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1004, ('a', 100.0999984741211, 6))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))]),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4)), (1003, ('a', 1.0, -9))]),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0)), (1006, ('a', 5.5, -3))],
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))]),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1004, ('b', 100.0999984741211, -6)),
    (1006, ('a', 2.0, 1)),
    (1006, ('b', -0.0, 0))])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('a', 3.25, 2)), (1000, ('b', -2.5, 5))],
   []),
  (1001, [(1001, ('a', -6.5, 4)), (1001, ('b', 8.0, -1))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('a', 100.0999984741211, 6)), (1004, ('b', 100.0999984741211, -6))],
   []),
  (1006,
   [(1006, ('a', 2.0, 1)), (1006, ('a', 5.5, -3)), (1006, ('b', -0.0, 0))],
   [(1000, ('a', 7.5, -7)),
    (1000, ('a', 3.25, 2)),
    (1001, ('a', -6.5, 4)),
    (1000, ('b', -2.5, 5)),
    (1001, ('b', 8.0, -1)),
    (1003, ('b', 0.5, 3))]),
  (1007, [(1007, ('a', 9.0, 11)), (1007, ('b', 4.0, 2))], [])],
 [(1000,
   [(1000, ('a', 7.5, -7)), (1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2))],
   []),
  (1001, [(1001, ('b', 8.0, -1)), (1001, ('a', -6.5, 4))], []),
  (1003,
   [(1003, ('a', 1.0, -9)), (1003, ('b', 0.5, 3)), (1003, ('b', 12.0, 8))],
   []),
  (1004,
   [(1004, ('b', 100.0999984741211, -6)), (1004, ('a', 100.0999984741211, 6))],
   [(1000, ('b', -2.5, 5)), (1000, ('a', 3.25, 2)), (1001, ('a', -6.5, 4))]),
  (1006,
   [(1006, ('a', 5.5, -3)), (1006, ('a', 2.0, 1)), (1006, ('b', -0.0, 0))],
   []),
  (1007,
   [(1007, ('b', 4.0, 2)), (1007, ('a', 9.0, 11))],
   [(1003, ('b', 0.5, 3)),
    (1003, ('b', 12.0, 8)),
    (1004, ('a', 100.0999984741211, 6))])],
 [(1000, [(1000, ('A', 60.0, 1))], []),
  (1001, [(1001, ('B', 30.0, 2))], []),
  (1002,
   [(1002, ('C', 50.0, 2)), (1002, ('A', 9.5, 3))],
   [(1000, ('A', 60.0, 1))]),
  (1003,
   [(1003, ('B', 45.0, 2)), (1003, ('C', None, 0))],
   [(1001, ('B', 30.0, 2)),
    (1002, ('C', 50.0, 1)),
    (1002, ('A', 9.5, 1)),
    (1003, ('B', 45.0, 0)),
    (1003, ('C', None, -1))]),
  (1004, [(1004, ('A', 20.0, 1)), (1004, ('B', 2.5, 2))], []),
  (1005,
   [(1005, ('C', 99.0, 1))],
   [(1004, ('A', 20.0, 1)), (1004, ('B', 2.5, 0))])],
 [(1000, [(1000, ('A', 60.0, 1))], []),
  (1001, [(1001, ('B', 30.0, 1))], []),
  (1002, [(1002, ('A', 9.5, 2)), (1002, ('C', 50.0, 1))], []),
  (1003,
   [(1003, ('B', 45.0, 2)), (1003, ('C', None, 0))],
   [(1002, ('C', 50.0, 0)), (1003, ('C', None, -1))]),
  (1004, [(1004, ('A', 20.0, 3)), (1004, ('B', 2.5, 3))], []),
  (1005, [(1005, ('C', 99.0, 1))], [])],
 [(1000, [(1000, ('A', 60.0, 1))], []),
  (1001, [(1001, ('B', 30.0, 1))], []),
  (1002,
   [(1002, ('C', 50.0, 1)), (1002, ('A', 9.5, 2))],
   [(1000, ('A', 60.0, 0))]),
  (1003,
   [(1003, ('C', None, 0)), (1003, ('B', 45.0, 2))],
   [(1002, ('C', 50.0, 1)), (1002, ('A', 9.5, 0)), (1003, ('C', None, -1))]),
  (1004, [(1004, ('A', 20.0, 1)), (1004, ('B', 2.5, 3))], []),
  (1005, [(1005, ('C', 99.0, 1))], [(1004, ('A', 20.0, 0))])],
 [(1000,
   [(1000, ('a', 1, 1.0, 1)),
    (1000, ('a', 2, -0.0, 2)),
    (1000, ('b', 1, 0.0, 1))],
   [(1000, ('a', 1, 1.0, 1)), (1000, ('a', 2, -0.0, 0))]),
  (1001,
   [(1001, ('a', 3, None, 1)),
    (1001, ('a', 3, None, 1)),
    (1001, ('b', 2, 1.5, 2))],
   [(1001, ('a', 3, None, 0)),
    (1001, ('b', 1, 0.0, 1)),
    (1001, ('b', 2, 1.5, 0))]),
  (1002,
   [(1002, ('a', 4, 0.0, 2)), (1002, ('c', 9, 9.0, 1))],
   [(1002, ('a', 4, 0.0, 1))]),
  (1003,
   [(1003, ('a', 1, 3.0, 2)),
    (1003, ('b', 5, 2.5, 1)),
    (1003, ('c', 9, None, 2))],
   [])],
 [(1000,
   [(1000, ('a', 1, 1.0, 1)),
    (1000, ('a', 1, 2.0, 1)),
    (1000, ('b', 1, 0.0, 1))],
   [(1000, ('a', 1, 1.0, 0))]),
  (1001,
   [(1001, ('a', 3, None, 1)), (1001, ('b', 1, -0.0, 1))],
   [(1001, ('a', 1, 2.0, 0)), (1001, ('b', 1, 0.0, 0))]),
  (1002,
   [(1002, ('a', 2, -0.0, 1)), (1002, ('c', 9, 9.0, 1))],
   [(1002, ('a', 3, None, 0))]),
  (1003,
   [(1003, ('c', 9, None, 1))],
   [(1003, ('a', 2, -0.0, 0)),
    (1003, ('b', 1, -0.0, 0)),
    (1003, ('c', 9, 9.0, 0))])],
 [(1000,
   [(1000, ('a', 1, 1.0, 1)),
    (1000, ('a', 2, -0.0, 2)),
    (1000, ('b', 1, 0.0, 1))],
   [(1000, ('a', 1, 1.0, 1)), (1000, ('a', 2, -0.0, 0))]),
  (1001,
   [(1001, ('a', 3, None, 1)),
    (1001, ('a', 3, None, 1)),
    (1001, ('b', 2, 1.5, 2))],
   [(1001, ('a', 3, None, 0)),
    (1001, ('b', 1, 0.0, 1)),
    (1001, ('b', 2, 1.5, 0))]),
  (1002,
   [(1002, ('a', 4, 0.0, 2)), (1002, ('c', 9, 9.0, 1))],
   [(1002, ('a', 4, 0.0, 1))]),
  (1003,
   [(1003, ('a', 1, 3.0, 2)),
    (1003, ('b', 5, 2.5, 1)),
    (1003, ('c', 9, None, 2))],
   [])],
 [(1000,
   [(1000, ('a', 1, 1.0, 1)),
    (1000, ('a', 2, -0.0, 2)),
    (1000, ('a', 1, 2.0, 2)),
    (1000, ('b', 1, 0.0, 1))],
   [(1000, ('a', 1, 1.0, 1))]),
  (1001,
   [(1001, ('a', 3, None, 2)),
    (1001, ('b', 2, 1.5, 2)),
    (1001, ('b', 1, -0.0, 2))],
   [(1001, ('a', 2, -0.0, 1)), (1001, ('b', 1, 0.0, 1))]),
  (1002,
   [(1002, ('a', 2, -0.0, 1)), (1002, ('c', 9, 9.0, 1))],
   [(1002, ('a', 1, 2.0, 1)), (1002, ('a', 3, None, 0))]),
  (1003,
   [(1003, ('a', 1, 3.0, 2)), (1003, ('c', 9, None, 1))],
   [(1003, ('b', 2, 1.5, 1)), (1003, ('c', 9, 9.0, 0))])],
 [(1000,
   [(1000, ('a', 1, 1.0, 1)),
    (1000, ('a', 2, -0.0, 2)),
    (1000, ('b', 1, 0.0, 2)),
    (1000, ('a', 1, 2.0, 2))],
   [(1000, ('a', 1, 1.0, 1)), (1000, ('b', 1, 0.0, 1))]),
  (1001,
   [(1001, ('b', 2, 1.5, 2)),
    (1001, ('b', 1, -0.0, 2)),
    (1001, ('a', 3, None, 1)),
    (1001, ('a', 3, None, 1))],
   [(1001, ('a', 2, -0.0, 1)),
    (1001, ('a', 1, 2.0, 1)),
    (1001, ('a', 3, None, 0))]),
  (1002,
   [(1002, ('a', 2, -0.0, 2)), (1002, ('a', 4, 0.0, 2))],
   [(1002, ('b', 2, 1.5, 1)), (1002, ('a', 4, 0.0, 1))]),
  (1003,
   [(1003, ('a', 1, 3.0, 2)), (1003, ('b', 5, 2.5, 2))],
   [(1003, ('b', 1, -0.0, 1)),
    (1003, ('a', 3, None, 1)),
    (1003, ('b', 5, 2.5, 0))])],
 [(1000,
   [(1000, ('a', 1, 1.0, 1)),
    (1000, ('a', 3, 3.0, 2)),
    (1000, ('b', 2, 2.0, 1))],
   []),
  (8000, [(8000, ('d', 4, 4.0, 1)), (8000, ('c', 3, 3.0, 1))], []),
  (9000,
   [(9000, ('a', 5, 5.0, 1)),
    (9000, ('a', 1, 1.0, 2)),
    (9000, ('e', 6, 6.0, 1))],
   []),
  (9500,
   [(9500, ('e', 6, 8.0, 1))],
   [(9500, ('a', 5, 5.0, 1)),
    (9500, ('a', 1, 1.0, 0)),
    (9500, ('e', 6, 6.0, 0))])]]
X12_CASES = [spec + (want,) for spec, want in
             zip(_X12_SPECS, _X12_WANT)]


# ---------------------------------------------------------------------------
# slice 13: the general mode of pattern_step (count atoms, logical pairs,
# sequences, a leading absent atom, timed logical-absent pairs, aggregators
# over pattern matches)
# ---------------------------------------------------------------------------

# Phase 49's forms: one app per form over two streams of different widths
# (T is wider than U, so a step on U also exercises the capture merge of a
# narrower stream), partitioned by key.
GEN_BASE = """
define stream T (key long, price float, volume int);
define stream U (key long, volume int);
partition with (key of T, key of U)
begin
  @capacity(keys='{keys}', slots='{slots}')
  @info(name='q')
  {body}
end;
"""
GEN_FORMS = [
    ("plus", 4, "from every e1=T[volume == 1], e2=T[volume == 2 and "
     "price >= e1.price]+, e3=T[volume == 3 and e2[last].price > price] "
     "select e1.price as a, e2[last].price as b, e2[0].price as c "
     "insert into O;"),
    ("star", 4, "from every e1=T[volume == 1] -> e2=T[volume == 2]<0:> -> "
     "e3=T[volume == 3] select e1.price as a, e2[0].price as b, "
     "e2[last].price as c, e3.price as d insert into O;"),
    ("optional", 4, "from every e1=T[volume == 2]<0:1> -> e2=U[volume == 3] "
     "-> e3=T[volume == 4] select e1.price as a, e2.volume as b, "
     "e3.price as c insert into O;"),
    ("range", 6, "from every e1=T[volume <= 2]<2:4> -> e2=U[volume == 3] "
     "select e1[0].price as a, e1[1].price as b, e1[last].price as c, "
     "e2.volume as d insert into O;"),
    ("count_pattern", 4, "from every e1=T[volume == 1] -> "
     "e2=U[volume >= 2]<1:> -> e3=T[volume == 1] select e1.price as a, "
     "e2[0].volume - e2[last].volume as b insert into O;"),
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
     "not U[volume == 2] for 40 milliseconds and e3=T[volume == 3] "
     "select e1.price as a, e3.price as b insert into O;"),
    ("absent_chain", 4, "from every e1=T[volume == 1] -> "
     "not U[volume == 2] for 30 milliseconds -> e3=T[volume == 3]<1:2> "
     "within 200 milliseconds select e1.price as a, e3[last].price as b "
     "insert into O;"),
    ("leading_absent", 4, "from every not U[volume == 2] for 30 "
     "milliseconds -> e2=T[volume == 3] select e2.price as a insert into "
     "O;"),
    ("sequence", 4, "from every e1=T[volume == 1], e2=T[volume <= 2]*, "
     "e3=T[volume == 3] select e1.price as a, e2[0].price as b, "
     "e3.price as c insert into O;"),
    ("not_every_or", 4, "from e1=T[volume == 1] or e2=U[volume == 2] -> "
     "e3=T[volume == 3] select e1.price as a, e2.volume as b, "
     "e3.price as c insert into O;"),
    ("having", 4, "from every e1=T[volume == 1] -> e2=T[volume == 2]<1:2> "
     "select e1.key as k, count() as n, sum(e2[last].volume) as s, "
     "max(e2[0].price) as m having m > 0.25 insert into O;"),
    # the flagship mode's rows through the selector over the whole grid
    ("flagship_having", 4, "from every e1=T[volume == 1] -> "
     "e2=U[volume == 2] select e1.key as k, count() as n, "
     "sum(e2.volume) as s having n > 1 insert into O;"),
]


def gen_app(body, keys, slots):
    return GEN_BASE.format(keys=keys, slots=slots, body=body)


def gen_send(np, rng, torch, dev, types, K, Kb, E, dense, clock, pad):
    """One random send of a phase-49 app's stream: keys, volumes 1-4,
    prices with NaN and -0.0, ts from `clock` in steps of 0-9 ms; the
    [Kb, E] selection with ~10% padding events; gather mode draws distinct
    keys and, with `pad`, ~5% padding rows."""
    B = Kb * E
    cols = []
    for t in types:
        if t == "LONG":
            c = rng.integers(0, K, B).astype(np.int64)
        elif t == "INT":
            c = rng.integers(1, 5, B).astype(np.int32)
        else:
            c = rng.random(B).astype(np.float32)
            c[rng.random(B) < 0.03] = np.nan
            c[rng.random(B) < 0.03] = -0.0
        cols.append(torch.from_numpy(c).to(dev))
    ts = clock + np.sort(rng.integers(0, 10 * E, B)).astype(np.int64)
    sel = rng.permutation(B).astype(np.int32).reshape(Kb, E)
    sel[rng.random((Kb, E)) < 0.1] = -1
    if dense:
        key_ref = int(rng.integers(0, K - Kb + 1))
    else:
        ki = rng.choice(K, Kb, replace=False).astype(np.int32)
        if pad:
            p = rng.random(Kb) < 0.05
            ki[p] = K
            sel[p] = -1
        key_ref = torch.from_numpy(ki).to(dev)
    wire = (int(ts[0]), torch.from_numpy((ts - ts[0]).astype(np.int32))
            .to(dev))
    return tuple(cols), wire, torch.from_numpy(ts).to(dev), \
        torch.from_numpy(sel).to(dev), key_ref, int(ts[-1])


def compare_general_plan(torch, np, planned, K, Kb, n_sends, rng, dev,
                         label, timers=True):
    """n_sends random steps (both streams, dense and gather, ts-delta and
    raw-ts wires, E from 1 to 4) and, for a plan with timers, a timer step
    after each, through the general mode and its plain version from one
    state: state words, `dropped`, header, rows and wake equal after each.
    Returns (max float difference, steps compared)."""
    plain = planned.init_state(K)[0]
    kern = clone_state(plain)
    sel_a = sel_b = planned.init_state(K)[1]
    sids = planned.spec.stream_ids
    has_timer = planned.timer_step is not None
    max_err, n, clock = 0.0, 0, 1000
    for i in range(n_sends):
        sid = sids[i % len(sids)]
        dense, wire, E = i % 2 == 0, i % 3 != 2, 1 + i % 4
        cols, tsw, raw_ts, sel, key_ref, now = gen_send(
            np, rng, torch, dev, planned.in_schemas[sid].types, K, Kb, E,
            dense, clock, pad=not has_timer)
        clock = now + 1
        steps = (planned.dense_steps_w if wire else planned.dense_steps) \
            if dense else (planned.steps_w if wire else planned.steps)
        ts_args = tsw if wire else (raw_ts,)
        before = clone_state(plain)
        a = steps[sid].plain(plain, sel_a, cols, *ts_args, sel, key_ref, now)
        b = steps[sid].kernel(kern, sel_b, cols, *ts_args, sel, key_ref, now)
        torch.cuda.synchronize()
        what = (f"{label} step {i} ({sid} {'dense' if dense else 'gather'} "
                f"{'ts-delta' if wire else 'raw-ts'} E={E})")
        if not torch.equal(a[0][0], b[0][0]) or \
                not torch.equal(a[0][1], b[0][1]):
            describe_state_mismatch(torch, planned, before, a[0], b[0], sel,
                                    key_ref, cols, ts_args, now)
        EP = E * (planned.slots + 1)
        compact = min(planned.compact_rows, EP) < EP
        max_err = max(max_err, absent_compare(torch, a, b, what, compact))
        plain, kern, sel_a, sel_b, n = a[0], b[0], a[1], b[1], n + 1
        if has_timer and timers:
            clock += 25
            a = planned.timer_step.plain(plain, sel_a, clock)
            b = planned.timer_step.kernel(kern, sel_b, clock)
            torch.cuda.synchronize()
            P1 = planned.slots + 1
            max_err = max(max_err, absent_compare(
                torch, a, b, f"{label} timer {i} at {clock}", 8 < P1))
            plain, kern, sel_a, sel_b, n = a[0], b[0], a[1], b[1], n + 1
    return max_err, n


def compare_general(torch, np, dev, keys=4096, Kb=1024, n_sends=8):
    """Phase 49's forms: each app's general mode against its plain version
    on seeded random traffic."""
    from siddhi_tpu_torch import SiddhiManager
    rng = np.random.default_rng(49)
    max_err, n = 0.0, 0
    for name, slots, body in GEN_FORMS:
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            gen_app(body, keys, slots))
        planned = rt.query_runtimes["q"].planned
        kp = planned.steps[planned.spec.stream_ids[0]].kernel_plan
        if kp.general == name.startswith("flagship"):
            fail(f"phase 49 {name}: planned the wrong mode")
        err, m = compare_general_plan(torch, np, planned, keys, Kb, n_sends,
                                      rng, dev, f"general {name}")
        max_err, n = max(max_err, err), n + m
    print(f"compare: pattern_step general mode == plain on "
          f"{len(GEN_FORMS)} forms over {n} steps, max_abs_err {max_err}")
    return max_err, n


# The slice's configurations, from the Siddhi 5.1 query guide's pattern
# examples (PK1 its counting sequence, CP1 its counting pattern, LG1 its
# logical pattern), and TP1, a timed `not X for t and Y` per key at A1's
# slab size
PK1_DEV = 1 << 20          # devices (@capacity(keys='1048576'))
PK1_BLOCK = 1 << 15        # devices a send, 4 readings each
PK1_SWEEPS = 3             # sweeps over every device
CP1_ROOMS = 1 << 16        # rooms (@capacity(keys='65536'))
CP1_REG = 1 << 14          # regulator events a round
CP1_ROUNDS = 16
LG1_ROOMS = 1 << 16
LG1_ROUNDS = 16
TP1_KEYS = 1 << 20
TP1_BLOCK = 1 << 17

PK1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (deviceID of TempStream)
begin
  @capacity(keys='{keys}', slots='4')
  @info(name='peak')
  from every e1=TempStream, e2=TempStream[e1.temp <= temp]+,
       e3=TempStream[e2[last].temp > temp]
  select e1.temp as initialTemp, e2[last].temp as peakTemp
  insert into PeekTempStream;
end;
"""
CP1_QL = """
@app:playback
define stream TemperatureStream (roomNo int, temp double);
define stream RegulatorStream (deviceID long, roomNo int, tempSet double,
                               isOn bool);
partition with (roomNo of RegulatorStream, roomNo of TemperatureStream)
begin
  @capacity(keys='{keys}')
  @info(name='diff')
  from every (e1=RegulatorStream)
       -> e2=TemperatureStream[e1.roomNo == roomNo]<1:>
       -> e3=RegulatorStream[e1.roomNo == roomNo]
  select e1.roomNo, e2[0].temp - e2[last].temp as tempDiff
  insert into TempDiffStream;
end;
"""
LG1_QL = """
@app:playback
define stream RegulatorStateChangeStream (deviceID long, roomNo int,
                                          tempSet double, action string);
define stream RoomKeyStream (deviceID long, roomNo int, action string);
partition with (roomNo of RegulatorStateChangeStream,
                roomNo of RoomKeyStream)
begin
  @capacity(keys='{keys}')
  @info(name='act')
  from every e1=RegulatorStateChangeStream[action == 'on']
       -> e2=RoomKeyStream[action == 'removed']
          or e3=RegulatorStateChangeStream[action == 'off']
  select e1.roomNo as roomNo, e2.action as keyAction
  having not (keyAction is null)
  insert into RegulatorActionStream;
end;
"""
TP1_QL = """
@app:playback
define stream S1 (key long, v int);
define stream S2 (key long, v int);
partition with (key of S1, key of S2)
begin
  @capacity(keys='{keys}', slots='2')
  @info(name='q')
  from every e1=S1[v == 1] -> not S2[v == 2] for 1 sec and e2=S2[v == 3]
  select e1.key as k, e2.v as v
  insert into Out;
end;
"""


def pk1_pattern(np, c, n):
    """Device class c's first n readings: runs rising 1-3 steps by 1-3
    degrees from a start 10 degrees below the last run's start."""
    rng = np.random.default_rng([13, c])
    out, k = [], 0
    while len(out) < n:
        v = 200 - 10 * k
        out.append(v)
        for _ in range(int(rng.integers(1, 4))):
            v += int(rng.integers(1, 4))
            out.append(v)
        k += 1
    return np.array(out[:n], np.float64)


def pk1_simulate(temps, P=4, cap=8):
    """An independent model of PK1's query on one device (the reference's
    sequence semantics at P slots and count cap 8): the matches as
    (reading index, initialTemp, peakTemp) and the dropped forks."""
    slots = [None] * P
    rows, drops = [], 0
    for i, t in enumerate(temps):
        free = [j for j in range(P) if slots[j] is None]
        forks, dead = [], []
        for j in range(P):
            s = slots[j]
            if s is None:
                continue
            if s[0] == 1:                          # collecting e2
                if t >= s[2]:
                    if s[1] + 1 < cap:
                        forks.append([2, 0, s[2], t])
                        s[1] += 1
                    else:
                        s[:] = [2, 0, s[2], t]
                else:
                    dead.append(j)                 # strict sequence
            else:                                  # waiting for e3
                if s[3] > t:
                    rows.append((i, s[2], s[3]))
                dead.append(j)
        cands = forks + [[1, 0, t, None]]          # then the seed
        drops += max(len(cands) - len(free), 0)
        for j, c in zip(free, cands):
            slots[j] = c
        for j in dead:
            slots[j] = None
    return rows, drops


class PK1Model:
    """PK1's traffic and its expected matches: device d reads class
    d % 8's saw-tooth plus (d % 251) * 300 degrees."""

    def __init__(self, np, sweeps=None):
        self.n = 4 * (sweeps or PK1_SWEEPS)
        self.devices, self.block = PK1_DEV, PK1_BLOCK
        self.pat = [pk1_pattern(np, c, self.n) for c in range(8)]
        self.sim = [pk1_simulate(list(p)) for p in self.pat]

    def send(self, np, i):
        """Send i: block i mod (devices / block), 4 readings each."""
        nb = self.devices // self.block
        b, w = i % nb, i // nb
        d = np.arange(b * self.block, (b + 1) * self.block, dtype=np.int64)
        dev = np.repeat(d, 4)
        r = np.tile(np.arange(4), self.block) + 4 * w
        pat = np.stack(self.pat)                   # [8, n]
        temp = pat[dev % 8, r] + (dev % 251) * 300.0
        ts = 1000 + 10 * i + np.tile(np.arange(4, dtype=np.int64),
                                     self.block)
        return [dev, (dev % 1000).astype(np.int32), temp], ts

    def expected(self, np, sweep):
        """(count, sorted (initialTemp, peakTemp) pairs) of the matches of
        one sweep (readings 4 sweep .. 4 sweep + 3 of every device)."""
        d = np.arange(self.devices, dtype=np.int64)
        off = (d % 251) * 300.0
        pairs = []
        for c in range(8):
            rows = [(a, b) for i, a, b in self.sim[c][0]
                    if 4 * sweep <= i < 4 * sweep + 4]
            dc = off[c::8]
            for a, b in rows:
                pairs.append(np.stack([a + dc, b + dc], 1))
        allp = np.concatenate(pairs) if pairs else np.zeros((0, 2))
        return allp.shape[0], allp[np.lexsort((allp[:, 1], allp[:, 0]))]

    def drops(self):
        return sum(self.sim[d % 8][1] for d in range(8)) * \
            (self.devices // 8)


def cp1_temp(np, rooms, rnd, j):
    return ((rooms * 7 + rnd * 13 + j * 5) % 40 + 10).astype(np.float64)


def cp1_sends(np, i):
    """Round i: regulator events for the rooms of block i mod 4, then two
    readings for every room."""
    rooms = np.arange((i % 4) * CP1_REG, (i % 4 + 1) * CP1_REG)
    t0 = 1000 + 100 * i
    reg = ([rooms.astype(np.int64) + 7, rooms.astype(np.int32),
            np.full(CP1_REG, 21.5), np.ones(CP1_REG, bool)],
           np.full(CP1_REG, t0, np.int64))
    allr = np.repeat(np.arange(CP1_ROOMS), 2)
    j = np.tile(np.arange(2), CP1_ROOMS)
    temps = ([allr.astype(np.int32), cp1_temp(np, allr, i, j)],
             t0 + 1 + j.astype(np.int64))
    return reg, temps


def cp1_expected(np, i):
    """Round i's rows: the regulator block b = i mod 4 fires in rounds with
    i mod 8 >= 4, 8 rows a room (tempDiff = t1 - tk over the 8 readings of
    rounds i-4 .. i-1), its seed dropped; else none."""
    if i % 8 < 4 or i < 4:
        return None
    b = i % 4
    rooms = np.arange(b * CP1_REG, (b + 1) * CP1_REG)
    ts = [cp1_temp(np, rooms, r, j) for r in range(i - 4, i)
          for j in range(2)]
    diffs = np.stack([ts[0] - t for t in ts], 1)      # [rooms, 8]
    return rooms, diffs


class LG1Model:
    """LG1: each round every room's state change ('on' with probability
    0.7, else 'off'), then key events for the rooms of one parity
    ('removed' with probability 0.4, else 'inserted').  Pending 'on's per
    room (at most 8 slots); a 'removed' fires them all, an 'off' clears
    them without a row."""

    def __init__(self, np):
        self.pend = np.zeros(LG1_ROOMS, np.int64)
        self.drops = 0
        self.rng = np.random.default_rng(131)

    def sends(self, np, i):
        rooms = np.arange(LG1_ROOMS)
        on = self.rng.random(LG1_ROOMS) < 0.7
        kr = rooms[(rooms + i) % 2 == 0]
        removed = self.rng.random(kr.shape[0]) < 0.4
        t0 = 1000 + 100 * i
        sc = ([rooms.astype(np.int64), rooms.astype(np.int32),
               np.full(LG1_ROOMS, 20.0),
               np.where(on, "on", "off").astype(object)],
              np.full(LG1_ROOMS, t0, np.int64))
        ks = ([kr.astype(np.int64), kr.astype(np.int32),
               np.where(removed, "removed", "inserted").astype(object)],
              np.full(kr.shape[0], t0 + 1, np.int64))
        # the model: 'on' seeds a slot (or drops at 8), 'off' clears
        self.drops += int((on & (self.pend == 8)).sum())
        self.pend = np.where(on, np.minimum(self.pend + 1, 8), 0)
        fired = kr[removed]
        rows = np.repeat(fired, self.pend[fired])
        self.pend[fired] = 0
        return sc, ks, np.sort(rows)


def tp1_sends(np, i):
    """TP1 round i: S1 (v = 1) for key block i mod 8 at 1000 + 250 i; 100
    ms later S2 for the same keys: v = 3 (the presence) on even keys,
    v = 2 (the absent side, killing) on odd keys."""
    blk = i % (TP1_KEYS // TP1_BLOCK)
    keys = np.arange(blk * TP1_BLOCK, (blk + 1) * TP1_BLOCK, dtype=np.int64)
    t1 = 1000 + 250 * i
    s1 = ([keys, np.ones(TP1_BLOCK, np.int32)],
          np.full(TP1_BLOCK, t1, np.int64))
    s2 = ([keys, np.where(keys % 2 == 0, 3, 2).astype(np.int32)],
          np.full(TP1_BLOCK, t1 + 100, np.int64))
    return s1, s2


def slot_args(torch, np, dev, cols, ts, key_col, E, dense, types):
    """A partitioned data step's device arguments from host columns sorted
    by key, E events a key, slot = key: (cols, ts base, ts delta, sel,
    key_ref, now)."""
    n = ts.shape[0]
    keys = np.asarray(cols[key_col])[::E]
    dcols = []
    for c, t in zip(cols, types):
        if t == "STRING":
            c = np.zeros(n, np.int32)              # ids: unused by these
        dcols.append(torch.from_numpy(np.ascontiguousarray(c).astype(
            {"LONG": np.int64, "INT": np.int32, "DOUBLE": np.float32,
             "FLOAT": np.float32, "BOOL": bool, "STRING": np.int32}[t]))
            .to(dev))
    sel = torch.arange(n, dtype=torch.int32, device=dev).view(-1, E)
    key_ref = int(keys[0]) if dense else \
        torch.from_numpy(keys.astype(np.int32)).to(dev)
    delta = torch.from_numpy((ts - ts[0]).astype(np.int32)).to(dev)
    return (tuple(dcols), int(ts[0]), delta, sel, key_ref, int(ts.max()))


def out_bytes(torch, kp, kout, full_grid):
    """Bytes of a launch's output rows and header.  Compacted rows are
    charged at full width.  On the whole grid (`full_grid`) an empty row
    needs only its valid flag, and full width is charged only for the
    rows that hold a match, as A1's timer bound charges them."""
    out_row = 8 + 4 + 1 + sum(torch.empty((), dtype=d).element_size()
                              for d in kp.emit_dtypes)
    nrows = kout[1].shape[0]
    if not full_grid:
        return nrows * out_row + 16
    return nrows + int(kout[3].sum()) * (out_row - 1) + 16


def gen_bound(torch, kp, before, after, args, kout):
    """Bytes one general-mode step must move for these inputs: the
    selection; the selected events' columns and ts deltas; each key's
    control words (P active flags, seed_on, done); for every slot live
    when the key's events arrive, its pos, count and lmask words and the
    capture words its atom's filters load (an `e[last]` load also reads
    the set's D ts words); every state word the step changed (captures at
    the depths written, fork copies, advances); the output rows and the
    header (`out_bytes`)."""
    from siddhi_tpu_torch.kernels.filter_bytecode import cap_loads
    t = kp.template
    P, S = kp.P, t.S
    cols, _, _, sel, key_ref, _ = args
    Kb = sel.shape[0]
    kc = (int(key_ref) + torch.arange(Kb, device=sel.device)) \
        if isinstance(key_ref, int) else key_ref.long()
    valid = sel >= 0
    n = sel.numel() * 4 + int(valid.sum()) * (
        sum(c.element_size() for c in cols) + 4)
    n += Kb * (P + 2) * 4
    b32 = before[0][:, kc]
    active = b32[t.off_active:t.off_active + P] != 0
    done = b32[t.off_done] != 0
    live = active & (valid.any(1) & ~done)[None]
    per_atom = []
    for a in range(S):
        nb = 12
        for s in (t.a_side[a], t.a_pside[a]):
            if s < 0 or t.s_code_len[s] == 0:
                continue
            code = list(t.code[t.s_code[s]:t.s_code[s] + t.s_code_len[s]])
            for st, c, d in cap_loads(code, with_depth=True):
                nb += 8 if t.s_ty[st][c] == 1 else 4
                if d < 0:
                    nb += 8 * t.s_depth[st]
        per_atom.append(nb)
    pos = b32[t.off_pos:t.off_pos + P].long().clamp(0, S - 1)
    n += int(torch.tensor(per_atom, device=sel.device)[pos][live].sum())
    n += int((after[0][:, kc] != b32).sum()) * 4
    n += int((after[1][:, kc] != before[1][:, kc]).sum()) * 8
    return n + out_bytes(torch, kp, kout, kp.full_grid)


def time_general(torch, label, planned, sid, dense, state, args,
                 plain_reps=2):
    """One data step's kernel launch (CUDA events, from a restored state)
    beside its plain step (`plain_reps` timed calls after a warm one) and
    its bound."""
    from siddhi_tpu_torch.kernels import pattern_step as ps
    steps = planned.dense_steps_w if dense else planned.steps_w
    step = steps[sid]
    kp = step.kernel_plan
    snap = clone_state(state)
    cols, base, delta, sel, key_ref, now = args

    def restore():
        restore_into(state, snap)

    def launch():
        return ps.launch(kp, state, cols, None, (base, delta), sel, key_ref,
                         now, dense)
    restore()
    kout = launch()[1]
    torch.cuda.synchronize()
    nb = gen_bound(torch, kp, snap, state, args, kout)
    ms = event_timer(torch, launch, 10, restore)
    step_ms = event_timer(torch, lambda: step.kernel(
        state, (), cols, base, delta, sel, key_ref, now), 5, restore)
    plain_ms = event_timer(torch, lambda: step.plain(
        state, (), cols, base, delta, sel, key_ref, now), plain_reps,
        restore)
    restore()
    res = dict(bound(nb), ms=ms, step_ms=step_ms, plain_ms=plain_ms)
    print(f"timing {label}: kernel {ms:.4f} ms/launch, kernel+selector "
          f"{step_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{res['bound_ms']:.5f} ms by {res['bound_by']} ({nb} bytes), "
          f"{res['bound_ms'] / ms:.4f} of the bound")
    return res


class GeneralTwin:
    """Wraps one step of a planned pattern query: each call runs the plain
    version on a copy of the state and the kernel on the state itself,
    compares state words, `dropped`, header, rows and wake, and returns
    the kernel's result.  Gather padding rows are left out of both (the
    plain step ticks a clamped copy of the last key for one)."""

    def __init__(self, torch, step, label, stats, timer=False):
        self.torch, self.step, self.label = torch, step, label
        self.stats, self.timer = stats, timer

    def __call__(self, packed, sel_state, *args, in_tabs=None):
        torch = self.torch
        kw = {} if in_tabs is None else {"in_tabs": in_tabs}
        if not self.timer:
            *front, sel, key_ref, now = args
            if not isinstance(key_ref, int):
                keep = key_ref < packed[0].shape[1]
                sel, key_ref = sel[keep].contiguous(), \
                    key_ref[keep].contiguous()
            args = (*front, sel, key_ref, now)
        sel_copy = tuple(x.clone() for x in sel_state)
        a = self.step.plain(clone_state(packed), sel_copy, *args, **kw)
        b = self.step.kernel(packed, sel_state, *args, **kw)
        torch.cuda.synchronize()
        n = self.stats["steps"]
        compact = False
        if not self.timer and not self.step.kernel_plan.full_grid:
            EP = args[-3].shape[1] * (self.step.kernel_plan.P + 1)
            compact = min(self.step.kernel_plan.compact_rows, EP) < EP
        elif self.timer and not self.step.kernel_plan.full_grid:
            compact = 8 < self.step.kernel_plan.P + 1
        err, _ = compare_steps(torch, a, b, f"{self.label} step {n}",
                               compact)
        if int(a[3]) != int(b[3]):
            fail(f"{self.label} step {n}: wake {int(a[3])} != {int(b[3])}")
        self.stats["steps"] += 1
        self.stats["err"] = max(self.stats["err"], err)
        return b


def x5_twins(torch, np, dev):
    """Phase 49 on every X5 case: each general-mode step and timer step of
    the case's run against its plain version (`GeneralTwin`)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core import runtime as rtm
    stats = {"steps": 0, "err": 0.0}
    orig = rtm.plan_pattern_query
    label = [""]

    def plan(*a, **k):
        p = orig(*a, **k)
        if not p.block:
            for steps in (p.steps, p.dense_steps, p.steps_w,
                          p.dense_steps_w):
                for sid, st in list(steps.items()):
                    if st.kernel_plan.general:
                        steps[sid] = GeneralTwin(torch, st, label[0], stats)
            if p.timer_step is not None and p.timer_step.kernel_plan.general:
                p.timer_step = GeneralTwin(torch, p.timer_step, label[0],
                                           stats, timer=True)
        return p
    rtm.plan_pattern_query = plan
    try:
        for name, ql, qname, sends, want in X5_CASES:
            label[0] = f"X5 {name}"
            got = corpus_run(SiddhiManager(device=dev), ql, qname, sends)
            if got != want:
                fail(f"X5 twins {name}: {got}, expected {want}")
    finally:
        rtm.plan_pattern_query = orig
    print(f"compare: general mode == plain on every X5 case, "
          f"{stats['steps']} steps (timer steps included), max_abs_err "
          f"{stats['err']}")
    return stats["err"]


def time_general_timer(torch, planned, state, now):
    """A general-mode timer launch over the whole slab (TP1: the first
    block's 65,536 timed pairs fall due) beside its plain version and the
    bytes it must move: each key's control words, the pos / lmask / entry
    words of its active slots, the words it changes, the valid flag of
    every output row and the whole of each fired row."""
    from siddhi_tpu_torch.kernels import pattern_step as ps
    kp = planned.timer_step.kernel_plan
    snap = clone_state(state)
    t = kp.template
    P, K = kp.P, state[0].shape[1]

    def restore():
        restore_into(state, snap)

    def launch():
        return ps.launch(kp, state, None, None, None, None, None, now, True,
                         timer=True)
    restore()
    kout = launch()[1]
    torch.cuda.synchronize()
    active = snap[0][t.off_active:t.off_active + P] != 0
    nb = K * (P + 2) * 4 + int(active.sum()) * 16
    nb += int((state[0] != snap[0]).sum()) * 4 + \
        int((state[1] != snap[1]).sum()) * 8
    nb += out_bytes(torch, kp, kout, True)
    ms = event_timer(torch, launch, 10, restore)
    plain_ms = event_timer(torch, lambda: planned.timer_step.plain(
        state, (), now), 2, restore)
    restore()
    res = dict(bound(nb), ms=ms, plain_ms=plain_ms)
    print(f"timing TP1 timer step ({K} keys, {int(kout[0][0])} fired): "
          f"kernel {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, bound "
          f"{res['bound_ms']:.5f} ms by {res['bound_by']} ({nb} bytes), "
          f"{res['bound_ms'] / ms:.4f} of the bound")
    return res


def config_twins(torch, np, dev, label, ql, qname, K, sends, timer_at=None):
    """Phase 49 at full size: `sends` ((stream, args fn, dense), ...) of a
    configuration through the general mode and its plain version from one
    state, then with `timer_at` a timer step at that time; returns (max
    err, the timing inputs of the first send, and with a timer step
    (planned, the state before it, its time))."""
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    planned = rt.query_runtimes[qname].planned
    plain = planned.init_state(K)[0]
    kern = clone_state(plain)
    max_err, first = 0.0, None
    for j, (sid, make, dense) in enumerate(sends):
        args = make(planned)
        steps = planned.dense_steps_w if dense else planned.steps_w
        before = clone_state(kern)
        a = steps[sid].plain(plain, planned.init_state(1)[1], *args)
        b = steps[sid].kernel(kern, planned.init_state(1)[1], *args)
        torch.cuda.synchronize()
        cols, base, delta, sel, key_ref, now = args
        if not torch.equal(a[0][0], b[0][0]) or \
                not torch.equal(a[0][1], b[0][1]):
            describe_state_mismatch(torch, planned, before, a[0], b[0], sel,
                                    key_ref, cols, (base, delta), now)
        E = sel.shape[1]
        EP = E * (planned.slots + 1)
        compact = min(planned.compact_rows, EP) < EP and \
            not steps[sid].kernel_plan.full_grid
        max_err = max(max_err, absent_compare(
            torch, a, b, f"{label} send {j} ({sid})", compact))
        if first is None:
            first = (planned, sid, dense, before, args)
        plain, kern = a[0], b[0]
    timer = None
    if timer_at is not None:
        before = clone_state(kern)
        a = planned.timer_step.plain(plain, planned.init_state(1)[1],
                                     timer_at)
        b = planned.timer_step.kernel(kern, planned.init_state(1)[1],
                                      timer_at)
        torch.cuda.synchronize()
        max_err = max(max_err, absent_compare(
            torch, a, b, f"{label} timer at {timer_at}",
            min(8, planned.slots + 1) < planned.slots + 1))
        timer = (planned, before, timer_at)
    del plain
    return max_err, first, timer


def s13_config_sends(np, torch, dev):
    """Phase 49's full-size sends of PK1, CP1 and LG1: two each."""
    pk = PK1Model(np, sweeps=1)
    pk_types = ["LONG", "INT", "DOUBLE"]

    def pk_send(i):
        cols, ts = pk.send(np, i)
        return lambda p: slot_args(torch, np, dev, cols, ts, 0, 4, True,
                                   pk_types)
    (rc, rt_), (tc, tt) = cp1_sends(np, 0)
    lg = LG1Model(np)
    (sc, st), (kc, kt), _ = lg.sends(np, 0)
    (c1, t1), (c2, t2) = tp1_sends(np, 0)
    tp_types = ["LONG", "INT"]
    return [
        ("PK1", PK1_QL.format(keys=PK1_DEV), "peak", PK1_DEV,
         [("TempStream", pk_send(0), True), ("TempStream", pk_send(1),
                                             True)]),
        ("CP1", CP1_QL.format(keys=CP1_ROOMS), "diff", CP1_ROOMS,
         [("RegulatorStream", lambda p: slot_args(
             torch, np, dev, rc, rt_, 1, 1, True,
             ["LONG", "INT", "DOUBLE", "BOOL"]), True),
          ("TemperatureStream", lambda p: slot_args(
              torch, np, dev, tc, tt, 0, 2, True, ["INT", "DOUBLE"]),
           True)]),
        ("LG1", LG1_QL.format(keys=LG1_ROOMS), "act", LG1_ROOMS,
         [("RegulatorStateChangeStream", lambda p: lg_args(
             torch, np, dev, p, "RegulatorStateChangeStream", sc, st, True),
           True),
          ("RoomKeyStream", lambda p: lg_args(
              torch, np, dev, p, "RoomKeyStream", kc, kt, False), False)]),
        ("TP1", TP1_QL.format(keys=TP1_KEYS), "q", TP1_KEYS,
         [("S1", lambda p: slot_args(torch, np, dev, c1, t1, 0, 1, True,
                                     tp_types), True),
          ("S2", lambda p: slot_args(torch, np, dev, c2, t2, 0, 1, True,
                                     tp_types), True)]),
    ]


def lg_args(torch, np, dev, planned, sid, cols, ts, dense):
    """LG1's step arguments with its action strings interned as the
    runtime interns them."""
    interner = planned.exec.interner
    ids = np.array([interner.intern(x) for x in cols[-1]], np.int32)
    types = planned.in_schemas[sid].types
    args = slot_args(torch, np, dev, list(cols[:-1]) + [ids], ts, 1, 1,
                     dense, list(types[:-1]) + ["INT"])
    return args


def s13_drive(torch, np, rt, qname, rounds, send_round):
    """Drive a configuration's rounds through SiddhiManager, collecting
    each batch's valid rows; returns (rows by round, latencies, wall)."""
    got = {}
    cur = [0]

    def on_batch(ts, b):
        if not b["n_current"]:
            return
        v = b["valid"]
        got.setdefault(cur[0], []).append(
            ({k: c[v] for k, c in b["cols"].items()}, b["ts"][v]))
    rt.add_batch_callback(qname, on_batch)
    rt.start()
    lat = []
    t0 = time.perf_counter()
    for i in range(rounds):
        cur[0] = i
        tb = time.perf_counter()
        send_round(i)
        rt.flush()
        lat.append(time.perf_counter() - tb)
    wall = time.perf_counter() - t0
    return got, lat, wall


def s13_profile(torch, rt, label, n, send_round):
    """A profiled sweep of n more rounds (on the card: device busy time,
    the idle share and the top device ops)."""
    if torch.cuda.is_available():
        profile_line(label, n, device_profile(torch, rt, n, send_round))


def s13_cat(np, parts, name):
    return np.concatenate([c[name] for c, _ in parts]) if parts else \
        np.zeros(0)


def run_pk1(torch, np, dev):
    """PK1 through SiddhiManager: 3 sweeps of 32 sends (32,768 devices x 4
    readings each); every sweep's matches held to the model, as sorted
    (initialTemp, peakTemp) pairs, and the dropped forks to its count."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(PK1_QL.format(keys=PK1_DEV))
    model = PK1Model(np)
    h = rt.get_input_handler("TempStream")
    nb = PK1_DEV // PK1_BLOCK
    sends = [model.send(np, i) for i in range(nb * PK1_SWEEPS)]
    ps.reset_counts()

    def send_round(i):
        cols, ts = sends[i]
        h.send_columns(cols, timestamps=ts)
    got, lat, wall = s13_drive(torch, np, rt, "peak", len(sends), send_round)
    launches, plain = ps.mode_launches[0], ps.plain_calls
    for w in range(PK1_SWEEPS):
        parts = [p for i in range(w * nb, (w + 1) * nb)
                 for p in got.get(i, [])]
        a = s13_cat(np, parts, "initialTemp").astype(np.float64)
        b = s13_cat(np, parts, "peakTemp").astype(np.float64)
        o = np.lexsort((b, a))
        n, want = model.expected(np, w)
        if a.shape[0] != n or not np.array_equal(
                np.stack([a[o], b[o]], 1), want):
            fail(f"PK1 sweep {w}: {a.shape[0]} matches, expected {n} (or "
                 f"the (initialTemp, peakTemp) pairs differ)")
    dropped = int(rt.query_runtimes["peak"].state[0][2][0])
    if dropped != model.drops():
        fail(f"PK1: {dropped} forks dropped, the model drops "
             f"{model.drops()}")
    if dev.type == "cuda" and (launches <= 0 or plain):
        fail(f"PK1: general-mode launches {launches}, plain calls {plain}")
    total = sum(model.expected(np, w)[0] for w in range(PK1_SWEEPS))
    print(f"PK1: {total} matches over {PK1_SWEEPS} sweeps equal the model "
          f"pair for pair, {dropped} forks dropped as modelled; "
          f"general-mode launches {launches}, plain calls {plain}")
    lat_line(np, "PK1", lat, wall, len(sends) * 4 * PK1_BLOCK,
             4 * PK1_BLOCK * (8 + 4 + 4 + 4 + 4))

    def again(b):
        cols, ts = sends[b]
        h.send_columns(cols, timestamps=ts + 10 ** 6)
    s13_profile(torch, rt, "PK1", 8, again)
    mgr.shutdown()
    return launches


def run_cp1(torch, np, dev):
    """CP1 through SiddhiManager: 16 rounds of 16,384 regulator events and
    131,072 readings; each round's rows held to the closed form (rooms and
    tempDiffs), the dropped seeds to its count."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(CP1_QL.format(keys=CP1_ROOMS))
    hr = rt.get_input_handler("RegulatorStream")
    ht = rt.get_input_handler("TemperatureStream")
    sends = [cp1_sends(np, i) for i in range(CP1_ROUNDS)]
    ps.reset_counts()

    def send_round(i):
        (rc, rts), (tc, tts) = sends[i]
        hr.send_columns(rc, timestamps=rts)
        ht.send_columns(tc, timestamps=tts)
    got, lat, wall = s13_drive(torch, np, rt, "diff", CP1_ROUNDS,
                               send_round)
    launches, plain = ps.mode_launches[0], ps.plain_calls
    total, fires = 0, 0
    for i in range(CP1_ROUNDS):
        parts = got.get(i, [])
        room = s13_cat(np, parts, "roomNo").astype(np.int64)
        diff = s13_cat(np, parts, "tempDiff").astype(np.float64)
        exp = cp1_expected(np, i)
        if exp is None:
            if room.shape[0]:
                fail(f"CP1 round {i}: {room.shape[0]} rows, expected none")
            continue
        rooms, diffs = exp
        o = np.lexsort((diff, room))
        want_r = np.repeat(rooms, 8)
        want_d = np.sort(diffs, 1).reshape(-1)
        if not (np.array_equal(room[o], want_r) and
                np.array_equal(diff[o], want_d)):
            fail(f"CP1 round {i}: {room.shape[0]} rows differ from the "
                 f"closed form ({want_r.shape[0]} rows)")
        total, fires = total + room.shape[0], fires + 1
    dropped = int(rt.query_runtimes["diff"].state[0][2][0])
    if dropped != fires * CP1_REG:
        fail(f"CP1: {dropped} seeds dropped, expected {fires * CP1_REG}")
    if dev.type == "cuda" and (launches <= 0 or plain):
        fail(f"CP1: general-mode launches {launches}, plain calls {plain}")
    print(f"CP1: {total} rows in {fires} firing rounds equal the closed "
          f"form room by room; {dropped} seeds dropped as expected; "
          f"general-mode launches {launches}, plain calls {plain}")
    lat_line(np, "CP1", lat, wall, CP1_ROUNDS * (CP1_REG + 2 * CP1_ROOMS),
             CP1_REG * 25 + 2 * CP1_ROOMS * 16)

    def again(b):
        (rc, rts), (tc, tts) = sends[b]
        hr.send_columns(rc, timestamps=rts + 10 ** 6)
        ht.send_columns(tc, timestamps=tts + 10 ** 6)
    s13_profile(torch, rt, "CP1", 4, again)
    mgr.shutdown()
    return launches


def run_lg1(torch, np, dev):
    """LG1 through SiddhiManager: 16 rounds of 65,536 state changes and
    32,768 key events; each round's rows (rooms, 'removed') held to the
    model, the dropped seeds to its count."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(LG1_QL.format(keys=LG1_ROOMS))
    qr = rt.query_runtimes["act"]
    intern = qr.planned.exec.interner.intern
    hs = rt.get_input_handler("RegulatorStateChangeStream")
    hk = rt.get_input_handler("RoomKeyStream")
    model = LG1Model(np)
    rounds = [model.sends(np, i) for i in range(LG1_ROUNDS)]
    ids = {s: intern(s) for s in ("on", "off", "removed", "inserted")}

    def enc(cols):
        return list(cols[:-1]) + [np.array([ids[x] for x in cols[-1]],
                                           np.int32)]
    enc_rounds = [(enc(sc), st, enc(kc), kt) for (sc, st), (kc, kt), _
                  in rounds]
    ps.reset_counts()

    def send_round(i):
        sc, st, kc, kt = enc_rounds[i]
        hs.send_columns(sc, timestamps=st)
        hk.send_columns(kc, timestamps=kt)
    got, lat, wall = s13_drive(torch, np, rt, "act", LG1_ROUNDS, send_round)
    launches, plain = ps.mode_launches[0], ps.plain_calls
    total = 0
    for i, (_, _, want) in enumerate(rounds):
        parts = got.get(i, [])
        room = np.sort(s13_cat(np, parts, "roomNo").astype(np.int64))
        act = s13_cat(np, parts, "keyAction")
        if not np.array_equal(room, want) or \
                not np.all(act == ids["removed"]):
            fail(f"LG1 round {i}: {room.shape[0]} rows, the model "
                 f"{want.shape[0]} (or rooms / actions differ)")
        total += room.shape[0]
    dropped = int(qr.state[0][2][0])
    if dropped != model.drops:
        fail(f"LG1: {dropped} seeds dropped, the model {model.drops}")
    if dev.type == "cuda" and (launches <= 0 or plain):
        fail(f"LG1: general-mode launches {launches}, plain calls {plain}")
    print(f"LG1: {total} rows equal the model room by room (having drops "
          f"the 'off' completions); {dropped} seeds dropped as modelled; "
          f"general-mode launches {launches}, plain calls {plain}")
    lat_line(np, "LG1", lat, wall, LG1_ROUNDS * (LG1_ROOMS + LG1_ROOMS // 2),
             LG1_ROOMS * 24 + LG1_ROOMS // 2 * 20)

    def again(b):
        sc, st, kc, kt = enc_rounds[b]
        hs.send_columns(sc, timestamps=st + 10 ** 6)
        hk.send_columns(kc, timestamps=kt + 10 ** 6)
    s13_profile(torch, rt, "LG1", 4, again)
    mgr.shutdown()
    return launches


def run_tp1(torch, np, dev):
    """TP1 through SiddhiManager at 2^20 keys: 16 rounds; the timer steps
    fire exactly the even keys of each block, once each, at e1.ts + 1000,
    through general-mode timer launches."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(TP1_QL.format(keys=TP1_KEYS))
    fired, bad = {}, []

    def on_batch(ts, b):
        if not b["n_current"]:
            return
        v = b["valid"]
        k, t = b["cols"]["k"][v], b["ts"][v]
        for tt in np.unique(t):
            i = (int(tt) - 2000) // 250
            kk = np.sort(k[t == tt])
            blk = i % (TP1_KEYS // TP1_BLOCK)
            want = np.arange(blk * TP1_BLOCK, (blk + 1) * TP1_BLOCK, 2)
            if not np.array_equal(kk, want) or \
                    not np.all(b["cols"]["v"][v][t == tt] == 3):
                bad.append(i)
            fired[i] = fired.get(i, 0) + kk.shape[0]
    rt.add_batch_callback("q", on_batch)
    rt.start()
    h1, h2 = rt.get_input_handler("S1"), rt.get_input_handler("S2")
    rounds = 16
    sends = [tp1_sends(np, i) for i in range(rounds)]
    ps.reset_counts()
    lat = []
    t0 = time.perf_counter()
    for (c1, t1), (c2, t2) in sends:
        tb = time.perf_counter()
        h1.send_columns(c1, timestamps=t1)
        h2.send_columns(c2, timestamps=t2)
        lat.append(time.perf_counter() - tb)
    rt.flush()
    wall = time.perf_counter() - t0
    timer, data = ps.mode_launches[1], ps.mode_launches[0]
    want = {i: TP1_BLOCK // 2 for i in range(rounds - 4)}
    if bad or fired != want:
        fail(f"TP1: fired {sorted(fired.items())[:6]}, bad rounds "
             f"{bad[:4]}; expected the even keys of rounds 0-{rounds - 5}")
    if dev.type == "cuda" and (timer <= 0 or ps.plain_calls):
        fail(f"TP1: general-mode timer launches {timer}, plain calls "
             f"{ps.plain_calls}")
    print(f"TP1: {sum(fired.values())} rows fired at their deadlines, the "
          f"even keys of every block once each; general-mode data launches "
          f"{data}, timer launches {timer}")
    lat_line(np, "TP1", lat, wall, rounds * 2 * TP1_BLOCK,
             2 * TP1_BLOCK * 16)
    more = [tp1_sends(np, rounds + i) for i in range(8)]

    def again(b):
        (c1, t1), (c2, t2) = more[b]
        h1.send_columns(c1, timestamps=t1)
        h2.send_columns(c2, timestamps=t2)
    s13_profile(torch, rt, "TP1", 8, again)
    mgr.shutdown()
    return data + timer


def s13_small_checks(torch, np):
    """PK1, CP1, LG1 and TP1 through the port on the CPU at a small size,
    held to the same models and closed forms as on the card (the CPU tests
    run this on the plain versions)."""
    g = globals()
    names = ("PK1_DEV", "PK1_BLOCK", "CP1_ROOMS", "CP1_REG", "LG1_ROOMS",
             "TP1_KEYS", "TP1_BLOCK")
    saved = {n: g[n] for n in names}
    g.update(PK1_DEV=1 << 9, PK1_BLOCK=1 << 6, CP1_ROOMS=1 << 8,
             CP1_REG=1 << 6, LG1_ROOMS=1 << 8, TP1_KEYS=1 << 9,
             TP1_BLOCK=1 << 6)
    try:
        cpu = torch.device("cpu")
        run_pk1(torch, np, cpu)
        run_cp1(torch, np, cpu)
        run_lg1(torch, np, cpu)
        run_tp1(torch, np, cpu)
    finally:
        g.update(saved)


def time_top_level(torch, np, dev):
    """A top-level count plan runs one key: one thread walks the whole
    send.  Its kernel time on one send of 1,024 events (recorded, not
    gated)."""
    from siddhi_tpu_torch import SiddhiManager
    ql = ("@app:playback\ndefine stream S1 (sym string, price float, "
          "vol int);\n@info(name='q') from every e1=S1[vol == 1] -> "
          "e2=S1[vol == 2]<1:3> -> e3=S1[vol == 3] select e1.price as a, "
          "e2[last].price as b, e3.price as c insert into O;")
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(ql)
    planned = rt.query_runtimes["q"].planned
    rng = np.random.default_rng(52)
    n = 1024
    cols = (torch.zeros(n, dtype=torch.int32, device=dev),
            torch.from_numpy(rng.random(n).astype(np.float32)).to(dev),
            torch.from_numpy(rng.integers(1, 4, n).astype(np.int32)).to(dev))
    ts = np.arange(1000, 1000 + n, dtype=np.int64)
    args = (cols, 1000, torch.from_numpy((ts - 1000).astype(np.int32))
            .to(dev), torch.arange(n, dtype=torch.int32, device=dev)[None],
            torch.zeros(1, dtype=torch.int32, device=dev), int(ts[-1]))
    state = planned.init_state(1)[0]
    # its plain step takes about 11 s a call: one timed call
    return time_general(torch, "top level (one key, 1,024 events a send)",
                        planned, "S1", False, state, args, plain_reps=1)


def slice13_phases(torch, np, dev):
    """Phases 49-52: the general mode (and its timer pass) against its
    plain version on every form and at full size; its times beside its
    bound; PK1, CP1, LG1 and TP1 through SiddhiManager; X5 against the
    JAX package's events.  Returns the general mode's kernel record."""
    from siddhi_tpu_torch.kernels import pattern_step as ps
    t0 = time.perf_counter()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 13 {what}: {time.perf_counter() - t0:.1f} s")
    err, n = compare_general(torch, np, dev)
    err = max(err, x5_twins(torch, np, dev))
    timing, ttiming = {}, None
    for label, ql, qname, K, sends in s13_config_sends(np, torch, dev):
        e, first, timer = config_twins(
            torch, np, dev, label, ql, qname, K, sends,
            2000 if label == "TP1" else None)
        err = max(err, e)
        timing[label] = first
        ttiming = timer or ttiming
    print(f"compare: general mode == plain at full size on PK1, CP1, LG1 "
          f"and TP1 (two sends each) and TP1's timer step, max_abs_err "
          f"{err}")
    took("phase 49 done")
    res = {}
    for label, (planned, sid, dense, before, args) in timing.items():
        res[label] = time_general(torch, f"{label} ({sid})", planned, sid,
                                  dense, clone_state(before), args)
    del timing
    res["timer"] = time_general_timer(torch, *ttiming)
    res["top"] = time_top_level(torch, np, dev)
    took("phase 50 done")
    launches = run_pk1(torch, np, dev)
    took("PK1 done")
    launches += run_cp1(torch, np, dev)
    took("CP1 done")
    launches += run_lg1(torch, np, dev)
    took("LG1 done")
    launches += run_tp1(torch, np, dev)
    took("phase 51 done")
    mods = {"pattern_step": ps}
    run_corpus(torch, np, dev, mods, "X5 (slice 13)", X5_CASES,
               ("pattern_step",))
    print(f"X5: general-mode launches {ps.mode_launches}")
    took("phase 52 done")
    t = res["PK1"]
    print(f"kernel pattern_step general mode: {t['ms']:.4f} ms at PK1's "
          f"send (bound {t['bound_ms']:.5f} by {t['bound_by']}), plain "
          f"{t['plain_ms']:.4f} ms, launches on the main paths {launches}; "
          f"library_ms null: no PyTorch call computes an NFA step")
    return [{"name": "pattern_step_general", "route": "cuda",
             "source": "siddhi_tpu_torch/csrc/pattern_step.cu",
             "replaces": "siddhi_tpu/core/pattern.py:313",
             "launches": launches, "max_abs_err": err, "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": None}]


# X5: the slice's corpus: every app of tests/test_pattern.py,
# test_pattern_corpus.py, test_sequence_corpus.py and test_absent_corpus.py
# that the JAX package runs (its sends with playback timestamps), the query
# guide's three pattern examples and their padded twins, and a leading
# absent atom with and without `every`; each at the top level and inside a
# value partition (x5_partition) with three keys a send.  A case whose
# narrower stream the reference cannot merge (a reference defect the port
# does not copy) carries a twin: the same app with that stream padded by
# dummy columns, which the JAX package runs.  _X5_WANT holds the JAX
# package's events; the CPU tests recompute them.
X5_GUIDE_SEQ = """@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
@info(name='q')
from every e1=TempStream, e2=TempStream[e1.temp <= temp]+,
     e3=TempStream[e2[last].temp > temp]
select e1.temp as initialTemp, e2[last].temp as peakTemp
insert into PeekTempStream;
"""
X5_GUIDE_COUNT = """@app:playback
define stream TemperatureStream (roomNo int, temp double{pad});
define stream RegulatorStream (deviceID long, roomNo int, tempSet double,
                               isOn bool);
@info(name='q')
from every (e1=RegulatorStream)
     -> e2=TemperatureStream[e1.roomNo == roomNo]<1:>
     -> e3=RegulatorStream[e1.roomNo == roomNo]
select e1.roomNo, e2[0].temp - e2[last].temp as tempDiff
insert into TempDiffStream;
"""
X5_GUIDE_LOGICAL = """@app:playback
define stream RegulatorStateChangeStream (deviceID long, roomNo int,
                                          tempSet double, action string);
define stream RoomKeyStream (deviceID long, roomNo int, action string{pad});
@info(name='q')
from every e1=RegulatorStateChangeStream[action == 'on']
     -> e2=RoomKeyStream[action == 'removed']
        or e3=RegulatorStateChangeStream[action == 'off']
select e1.roomNo as roomNo, e2.action as keyAction
having not (keyAction is null)
insert into RegulatorActionStream;
"""
X5_LEADING = """@app:playback
define stream S1 (sym string, price float, vol int);
define stream S2 (sym string, price float, vol int);
@info(name='q')
from {every}not S2[vol == 2] for 1 sec -> e2=S1[vol == 1]
select e2.sym as s insert into Out;
"""
_X5_SEQ_SENDS = [("TempStream", [d, 1, t], 1000 + i) for i, (d, t) in
                 enumerate([(1, 20.0), (2, 30.0), (1, 22.0), (1, 25.0),
                            (2, 31.0), (1, 21.0), (2, 29.0), (1, 24.0),
                            (1, 24.0), (1, 23.0), (2, 35.0), (2, 33.0)])]
_X5_COUNT_SENDS = [
    ("RegulatorStream", [1, 10, 20.0, True], 1000),
    ("RegulatorStream", [2, 11, 21.0, True], 1000),
    ("TemperatureStream", [10, 30.0], 1001),
    ("TemperatureStream", [11, 25.0], 1001),
    ("TemperatureStream", [10, 28.0], 1002),
    ("TemperatureStream", [10, 27.0], 1003),
    ("TemperatureStream", [11, 22.5], 1003),
    ("RegulatorStream", [1, 10, 20.0, False], 1004),
    ("TemperatureStream", [10, 26.0], 1005),
    ("RegulatorStream", [2, 11, 20.0, False], 1006)]
_X5_LOGICAL_SENDS = [
    ("RegulatorStateChangeStream", [1, 5, 20.0, "on"], 1000),
    ("RegulatorStateChangeStream", [2, 6, 20.0, "on"], 1000),
    ("RoomKeyStream", [1, 5, "removed"], 1001),
    ("RegulatorStateChangeStream", [2, 6, 20.0, "off"], 1002),
    ("RegulatorStateChangeStream", [2, 6, 20.0, "on"], 1003),
    ("RoomKeyStream", [2, 6, "inserted"], 1004),
    ("RoomKeyStream", [2, 6, "removed"], 1005)]
_X5_LEADING_SENDS = [("S1", ["a", 1.0, 1], 1000), ("S1", ["b", 1.0, 1], 2500),
                     ("S2", ["c", 1.0, 2], 2600), ("S1", ["d", 1.0, 1], 4000)]


def _x5_pad(sends, stream, n):
    return [(s, r + [0] * n if s == stream else r, t) for s, r, t in sends]


def _x5_guide():
    """The guide's examples: (name, ql, query, sends, twin)."""
    cnt, lg = X5_GUIDE_COUNT.format(pad=""), X5_GUIDE_LOGICAL.format(pad="")
    cnt2 = X5_GUIDE_COUNT.format(pad=", d1 long, d2 long")
    lg2 = X5_GUIDE_LOGICAL.format(pad=", d1 long")
    cs2 = _x5_pad(_X5_COUNT_SENDS, "TemperatureStream", 2)
    ls2 = _x5_pad(_X5_LOGICAL_SENDS, "RoomKeyStream", 1)
    return [
        ("guide_counting_sequence", X5_GUIDE_SEQ, "q", _X5_SEQ_SENDS, None),
        ("guide_counting_pattern", cnt, "q", _X5_COUNT_SENDS, (cnt2, cs2)),
        ("guide_counting_pattern_padded", cnt2, "q", cs2, None),
        ("guide_logical_pattern", lg, "q", _X5_LOGICAL_SENDS, (lg2, ls2)),
        ("guide_logical_pattern_padded", lg2, "q", ls2, None),
        ("leading_absent", X5_LEADING.format(every=""), "q",
         _X5_LEADING_SENDS, None),
        ("leading_absent_every", X5_LEADING.format(every="every "), "q",
         _X5_LEADING_SENDS, None)]


def x5_partition(ql, sends, twin=None):
    """A top-level case inside a value partition: every stream gains a
    leading `pk int` column, the queries run inside `partition with (pk of
    ...)`, and every send carries the event for keys 0, 1 and 2."""
    import re

    def part(q, ss):
        names = re.findall(r"define stream (\w+)\s*\(", q)
        q = re.sub(r"(define stream \w+\s*\()", r"\1pk int, ", q)
        end = max(m.end() for m in re.finditer(r"define stream [^;]*;", q))
        head, body = q[:end], q[end:]
        keys = ", ".join(f"pk of {n}" for n in names)
        q = f"{head}\npartition with ({keys})\nbegin\n{body}\nend;\n"
        return q, [(s, [[k] + r for k in range(3)], t) for s, r, t in ss]
    pq, ps = part(ql, sends)
    return pq, ps, (part(*twin) if twin is not None else None)


X5_RANGE = """@app:playback
define stream S1 (sym string, price float, vol int);
partition with (price >= 50.0 as 'high' or price < 50.0 as 'low' of S1)
begin
@info(name='q')
from every e1=S1[vol == 1] -> e2=S1[vol == 2]<1:2>
select e1.sym as s, sum(e2[last].price) as t, count() as n
having n > 1
insert into Out;
end;
"""
_X5_RANGE_SENDS = [("S1", [["a", 60.0, 1], ["b", 10.0, 1]], 1000),
                   ("S1", [["c", 70.0, 2], ["d", 20.0, 2]], 1001),
                   ("S1", [["e", 80.0, 2]], 1002),
                   ("S1", [["f", 55.0, 1], ["g", 15.0, 2]], 1003),
                   ("S1", [["h", 65.0, 2], ["i", 5.0, 1]], 1004),
                   ("S1", [["j", 30.0, 2]], 1005)]


def x5_specs():
    """(name, ql, query, sends, twin) of every X5 case: each corpus app and
    guide example at the top level, then inside a value partition, then
    aggregators over a count pattern in a range partition."""
    top = [t + (None,) for t in _X5_TESTS] + _x5_guide()
    part = []
    for name, ql, q, sends, twin in top:
        pq, psends, ptwin = x5_partition(ql, sends, twin)
        part.append((f"{name}@partition", pq, q, psends, ptwin))
    return top + part + [("range_partition_aggregates", X5_RANGE, "q",
                          _X5_RANGE_SENDS, None)]


_X5_TESTS = [('pattern:simple_followed_by',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1[price > 20] -> e2=Stream2[price > e1.price]\n'
  'select e1.symbol as s1, e2.symbol as s2, e2.price as p2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['WSO2', 55.6, 100], 1000),
   ('Stream2', ['IBM', 45.7, 100], 1010),
   ('Stream2', ['GOOG', 85.0, 100], 1020),
   ('Stream2', ['MSFT', 95.0, 100], 1030)]),
 ('pattern:without_every_matches_once',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1 -> e2=Stream2\n'
  'select e1.volume as v1, e2.volume as v2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream1', ['A', 1.0, 2], 1001),
   ('Stream2', ['B', 1.0, 3], 1002),
   ('Stream1', ['A', 1.0, 4], 1003),
   ('Stream2', ['B', 1.0, 5], 1004)]),
 ('pattern:every_restarts',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from every e1=Stream1 -> e2=Stream2\n'
  'select e1.volume as v1, e2.volume as v2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream1', ['A', 1.0, 2], 1001),
   ('Stream2', ['B', 1.0, 3], 1002),
   ('Stream1', ['A', 1.0, 4], 1003),
   ('Stream2', ['B', 1.0, 5], 1004)]),
 ('pattern:three_state_chain',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from every e1=Stream1[volume == 1] -> e2=Stream1[volume == 2]\n'
  '-> e3=Stream1[volume == 3]\n'
  'select e1.symbol as s1, e2.symbol as s2, e3.symbol as s3\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream1', ['B', 1.0, 2], 1001),
   ('Stream1', ['X', 1.0, 9], 1002),
   ('Stream1', ['C', 1.0, 3], 1003)]),
 ('pattern:within_expires',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from every e1=Stream1 -> e2=Stream2 within 1 sec\n'
  'select e1.volume as v1, e2.volume as v2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream2', ['B', 1.0, 2], 2500),
   ('Stream1', ['A', 1.0, 3], 3000),
   ('Stream2', ['B', 1.0, 4], 3600)]),
 ('pattern:count_quantifier',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1 -> e2=Stream1[volume > 10]<2:4> -> e3=Stream1[volume == '
  '0]\n'
  'select e1.volume as v1, e2[0].volume as a, e2[1].volume as b,\n'
  'e3.volume as v3\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['S', 1.0, 5], 1000),
   ('Stream1', ['S', 1.0, 11], 1001),
   ('Stream1', ['S', 1.0, 12], 1002),
   ('Stream1', ['S', 1.0, 0], 1003)]),
 ('pattern:logical_and',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1 and e2=Stream2\n'
  'select e1.volume as v1, e2.volume as v2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000), ('Stream2', ['B', 1.0, 2], 1001)]),
 ('pattern:logical_or',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1[volume == 7] or e2=Stream2[volume == 8]\n'
  'select e2.volume as v2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000), ('Stream2', ['B', 1.0, 8], 1001)]),
 ('pattern:absent_pattern',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1 -> not Stream2 for 1 sec\n'
  'select e1.volume as v1\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000), ('Stream1', ['X', 1.0, 99], 2500)]),
 ('pattern:absent_pattern_violated',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from e1=Stream1 -> not Stream2 for 1 sec\n'
  'select e1.volume as v1\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream2', ['B', 1.0, 2], 1400),
   ('Stream1', ['X', 1.0, 99], 2500)]),
 ('pattern:strict_sequence',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from every e1=Stream1[volume == 1], e2=Stream1[volume == 2]\n'
  'select e1.symbol as s1, e2.symbol as s2\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream1', ['X', 1.0, 9], 1001),
   ('Stream1', ['B', 1.0, 1], 1002),
   ('Stream1', ['C', 1.0, 2], 1003)]),
 ('pattern:sequence_kleene',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='query1')\n"
  'from every e1=Stream1[volume == 1], e2=Stream1[volume == 5]+,\n'
  'e3=Stream1[volume == 2]\n'
  'select e1.symbol as s1, e2[0].symbol as k0, e3.symbol as s3\n'
  'insert into OutputStream;\n',
  'query1',
  [('Stream1', ['A', 1.0, 1], 1000),
   ('Stream1', ['K', 1.0, 5], 1001),
   ('Stream1', ['L', 1.0, 5], 1002),
   ('Stream1', ['B', 1.0, 2], 1003)]),
 ('pattern_corpus:followed_by_basic',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000), ('S2', ['y', 1.0, 2], 1001)]),
 ('pattern_corpus:followed_by_no_every_fires_once',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000),
   ('S2', ['y', 1.0, 2], 1001),
   ('S1', ['p', 1.0, 1], 1002),
   ('S2', ['q', 1.0, 2], 1003)]),
 ('pattern_corpus:every_restarts',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000),
   ('S2', ['y', 1.0, 2], 1001),
   ('S1', ['p', 1.0, 1], 1002),
   ('S2', ['q', 1.0, 2], 1003)]),
 ('pattern_corpus:capture_filter_cross_reference',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1]\n"
  '-> e2=S2[price > e1.price]\n'
  'select e1.price as p1, e2.price as p2 insert into Out;\n',
  'q',
  [('S1', ['a', 10.0, 1], 1000),
   ('S2', ['b', 5.0, 0], 1001),
   ('S2', ['c', 15.0, 0], 1002)]),
 ('pattern_corpus:count_quantifier_range',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S1[vol == 5]<2:3>\n"
  '-> e3=S1[vol == 9]\n'
  'select e2[0].price as k0, e2[1].price as k1 insert into Out;\n',
  'q',
  [('S1', ['s', 0.0, 1], 1000),
   ('S1', ['s', 1.0, 5], 1001),
   ('S1', ['s', 2.0, 5], 1002),
   ('S1', ['s', 0.0, 9], 1003)]),
 ('pattern_corpus:count_quantifier_min_not_met',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S1[vol == 5]<2:3>\n"
  '-> e3=S1[vol == 9]\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['s', 0.0, 1], 1000),
   ('S1', ['s', 1.0, 5], 1001),
   ('S1', ['s', 0.0, 9], 1002)]),
 ('pattern_corpus:logical_and_pattern',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] and e2=S2[vol == 2]\n"
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S2', ['y', 1.0, 2], 1000), ('S1', ['x', 1.0, 1], 1001)]),
 ('pattern_corpus:logical_or_pattern',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 2]\n"
  'select e2.sym as b insert into Out;\n',
  'q',
  [('S2', ['y', 1.0, 2], 1000)]),
 ('pattern_corpus:within_expires_partial',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  'within 1 sec\n'
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000), ('S2', ['y', 1.0, 2], 2500)]),
 ('pattern_corpus:within_met',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  'within 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000), ('S2', ['y', 1.0, 2], 1800)]),
 ('pattern_corpus:absent_fires_after_timeout',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> not S2 for 1 sec\n"
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000), ('S1', ['z', 1.0, 9], 2500)]),
 ('pattern_corpus:absent_suppressed_by_arrival',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> not S2 for 1 sec\n"
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000),
   ('S2', ['y', 1.0, 2], 1500),
   ('S1', ['z', 1.0, 9], 2500)]),
 ('pattern_corpus:sequence_strictness',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1], e2=S1[vol == 2]\n"
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S1', ['k', 1.0, 7], 1001),
   ('S1', ['b', 1.0, 2], 1002),
   ('S1', ['c', 1.0, 1], 1003),
   ('S1', ['d', 1.0, 2], 1004)]),
 ('pattern_corpus:sequence_kleene_plus',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1], e2=S1[vol == 5]+,\n"
  'e3=S1[vol == 2]\n'
  'select e1.sym as a, e2[0].sym as k0, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S1', ['k', 1.0, 5], 1001),
   ('S1', ['l', 1.0, 5], 1002),
   ('S1', ['b', 1.0, 2], 1003)]),
 ('pattern_corpus:pattern_output_aggregation',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  'select count() as n insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000),
   ('S2', ['y', 1.0, 2], 1001),
   ('S1', ['p', 1.0, 1], 1002),
   ('S2', ['q', 1.0, 2], 1003)]),
 ('pattern_corpus:multi_stream_three_stage',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2]\n"
  '-> e3=S1[vol == 3]\n'
  'select e1.sym as a, e2.sym as b, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['x', 1.0, 1], 1000),
   ('S2', ['y', 1.0, 2], 1001),
   ('S1', ['z', 1.0, 3], 1002)]),
 ('sequence_corpus:strict_sequence_matches_adjacent',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from e1=Stream1[price>20], e2=Stream2[price>e1.price]\n'
  'select e1.price as p1, e2.price as p2 insert into Out;\n',
  'q',
  [('Stream1', ['WSO2', 55.6, 100], 1000),
   ('Stream2', ['IBM', 55.7, 100], 1010)]),
 ('sequence_corpus:strict_sequence_broken_by_nonmatching_next',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from e1=Stream1[price>20], e2=Stream1[price>e1.price]\n'
  'select e1.price as p1, e2.price as p2 insert into Out;\n',
  'q',
  [('Stream1', ['WSO2', 55.6, 100], 1000),
   ('Stream1', ['LOW', 10.0, 100], 1010),
   ('Stream1', ['IBM', 95.7, 100], 1020)]),
 ('sequence_corpus:every_sequence_restarts',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream1[price>20], e2=Stream1[price>e1.price]\n'
  'select e1.price as p1, e2.price as p2 insert into Out;\n',
  'q',
  [('Stream1', ['A', 25.0, 100], 1000),
   ('Stream1', ['B', 30.0, 100], 1010),
   ('Stream1', ['C', 26.0, 100], 1020),
   ('Stream1', ['D', 55.0, 100], 1030)]),
 ('sequence_corpus:kleene_star_collects_then_closes',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream2[price>20]*, e2=Stream1[price>e1[0].price]\n'
  'select e1[0].price as p0, e2.price as p2 insert into Out;\n',
  'q',
  [('Stream2', ['A', 25.0, 100], 1000), ('Stream1', ['B', 26.0, 100], 1010)]),
 ('sequence_corpus:kleene_plus_requires_at_least_one',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream2[price>20]+, e2=Stream1[price>e1[0].price]\n'
  'select e1[0].price as p0, e2.price as p2 insert into Out;\n',
  'q',
  [('Stream1', ['X', 99.0, 100], 1000),
   ('Stream2', ['A', 25.0, 100], 1010),
   ('Stream1', ['B', 26.0, 100], 1020)]),
 ('sequence_corpus:optional_question_mark',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream2[price>20]?, e2=Stream1[price>30]\n'
  'select e2.price as p2 insert into Out;\n',
  'q',
  [('Stream1', ['B', 35.0, 100], 1000)]),
 ('sequence_corpus:or_partner_in_sequence',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream2[price>20], e2=Stream2[price>e1.price]\n'
  "or e3=Stream2[symbol=='IBM']\n"
  'select e1.price as p1, e2.price as p2, e3.symbol as s3\n'
  'insert into Out;\n',
  'q',
  [('Stream2', ['A', 25.0, 100], 1000),
   ('Stream2', ['IBM', 10.0, 100], 1010)]),
 ('sequence_corpus:and_partner_in_sequence',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  "from e1=Stream1[price>20], e2=Stream2['IBM' == symbol]\n"
  "and e3=Stream2['WSO2' == symbol]\n"
  'select e1.price as p1, e2.symbol as s2, e3.symbol as s3\n'
  'insert into Out;\n',
  'q',
  [('Stream1', ['A', 25.0, 100], 1000),
   ('Stream2', ['IBM', 10.0, 100], 1010),
   ('Stream2', ['WSO2', 11.0, 100], 1020)]),
 ('sequence_corpus:counting_capture_last_index',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream1[price>20]+, e2=Stream1[price<10]\n'
  'select e1[0].price as first, e1[last].price as last_p\n'
  'insert into Out;\n',
  'q',
  [('Stream1', ['A', 25.0, 100], 1000),
   ('Stream1', ['B', 30.0, 100], 1010),
   ('Stream1', ['C', 5.0, 100], 1020)]),
 ('sequence_corpus:sequence_from_two_streams_interleaved',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream1[price >= 50 and volume > 100],\n'
  'e2=Stream2[price <= 40]*, e3=Stream2[volume <= 70]\n'
  'select e1.symbol as s1, e2[0].symbol as s2, e3.symbol as s3\n'
  'insert into Out;\n',
  'q',
  [('Stream1', ['IBM', 75.0, 105], 1000),
   ('Stream2', ['GOOG', 21.0, 81], 1010),
   ('Stream2', ['WSO2', 176.6, 65], 1020)]),
 ('sequence_corpus:sequence_group_by_output',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream1[price>20], e2=Stream1[price>e1.price]\n'
  'select e1.symbol as s, sum(e2.price) as total group by e1.symbol\n'
  'insert into Out;\n',
  'q',
  [('Stream1', ['A', 25.0, 100], 1000),
   ('Stream1', ['B', 30.0, 100], 1010),
   ('Stream1', ['A', 26.0, 100], 1020),
   ('Stream1', ['Z', 55.0, 100], 1030)]),
 ('sequence_corpus:skip_and_collect_interpretations_coexist',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream1[price > 10]*, e2=Stream1[price > 20]\n'
  'select e1[0].price as p0, e2.price as p2 insert into Out;\n',
  'q',
  [('Stream1', ['X', 25.0, 100], 1000), ('Stream1', ['Y', 30.0, 100], 1010)]),
 ('sequence_corpus:skip_completion_leaves_origin_collection_intact',
  '@app:playback\n'
  'define stream Stream1 (symbol string, price float, volume int);\n'
  'define stream Stream2 (symbol string, price float, volume int);\n'
  "@info(name='q')\n"
  'from every e1=Stream2[price>20]*, e2=Stream1[price>0]\n'
  'select e1[0].price as p0, e1[last].price as pl, e2.price as p2\n'
  'insert into Out;\n',
  'q',
  [('Stream1', ['B1', 1.0, 1], 1000),
   ('Stream2', ['A1', 25.0, 1], 1010),
   ('Stream2', ['A2', 30.0, 1], 1020),
   ('Stream1', ['B2', 2.0, 1], 1030)]),
 ('absent_corpus:absent_filter_on_absent_stream_suppresses',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[price > 20.0] ->\n"
  'not S2[price > e1.price] for 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['WSO2', 55.6, 100], 1000),
   ('S2', ['IBM', 58.7, 10], 1100),
   ('S1', ['tick', 99.0, 1], 2500)]),
 ('absent_corpus:absent_nonmatching_arrival_does_not_suppress',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[price > 20.0] ->\n"
  'not S2[price > e1.price] for 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['WSO2', 55.6, 100], 1000),
   ('S2', ['IBM', 45.7, 10], 1100),
   ('S1', ['tick', 9.0, 1], 2500)]),
 ('absent_corpus:absent_arrival_after_timeout_is_too_late',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[price > 20.0] ->\n"
  'not S2[price > e1.price] for 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['WSO2', 55.6, 100], 1000), ('S2', ['IBM', 58.7, 10], 2100)]),
 ('absent_corpus:absent_two_stage_chain',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2] ->\n"
  'not S3[vol == 3] for 1 sec\n'
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S2', ['b', 1.0, 2], 1200),
   ('S1', ['tick', 1.0, 9], 2600)]),
 ('absent_corpus:absent_two_stage_chain_violated',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> e2=S2[vol == 2] ->\n"
  'not S3[vol == 3] for 1 sec\n'
  'select e1.sym as a, e2.sym as b insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S2', ['b', 1.0, 2], 1200),
   ('S3', ['c', 1.0, 3], 1900),
   ('S1', ['tick', 1.0, 9], 2600)]),
 ('absent_corpus:absent_then_presence_continues_chain',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> not S2 for 1 sec ->\n"
  'e3=S3[vol == 3]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S3', ['early', 1.0, 3], 1500),
   ('S3', ['c', 1.0, 3], 2400)]),
 ('absent_corpus:every_absent_fires_per_seed',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1] -> not S2 for 1 sec\n"
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S1', ['b', 1.0, 1], 1400),
   ('S1', ['tick', 1.0, 9], 3000)]),
 ('absent_corpus:every_absent_partial_suppression',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from every e1=S1[vol == 1] -> not S2 for 1 sec\n"
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S1', ['b', 1.0, 1], 1800),
   ('S2', ['kill', 1.0, 2], 1900),
   ('S1', ['tick', 1.0, 9], 3500)]),
 ('absent_corpus:logical_absent_and_presence',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from not S2[price > 20.0] and e3=S3[price > 30.0]\n"
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S3', ['ok', 35.0, 1], 1000)]),
 ('absent_corpus:logical_absent_and_presence_violated',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from not S2[price > 20.0] and e3=S3[price > 30.0]\n"
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S2', ['bad', 25.0, 1], 900), ('S3', ['x', 35.0, 1], 1000)]),
 ('absent_corpus:chained_logical_absent',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[price > 10.0] ->\n"
  'not S2[price > 20.0] and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 15.0, 1], 1000), ('S3', ['c', 35.0, 1], 1200)]),
 ('absent_corpus:chained_logical_absent_violated',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[price > 10.0] ->\n"
  'not S2[price > 20.0] and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 15.0, 1], 1000),
   ('S2', ['kill', 25.0, 1], 1100),
   ('S3', ['c', 35.0, 1], 1200)]),
 ('absent_corpus:absent_within_interaction',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] -> not S2 for 2 sec\n"
  'within 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000), ('S1', ['tick', 1.0, 9], 4000)]),
 ('absent_corpus:logical_absent_second_side',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e3=S3[price > 30.0] and not S2[price > 20.0]\n"
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S3', ['ok', 35.0, 1], 1000)]),
 ('absent_corpus:logical_absent_second_side_violated',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e3=S3[price > 30.0] and not S2[price > 20.0]\n"
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S2', ['bad', 25.0, 1], 900), ('S3', ['x', 35.0, 1], 1000)]),
 ('absent_corpus:logical_absent_nonmatching_arrival_ignored',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from not S2[price > 20.0] and e3=S3[price > 30.0]\n"
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S2', ['low', 5.0, 1], 900), ('S3', ['ok', 35.0, 1], 1000)]),
 ('absent_corpus:every_logical_absent_rearms',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from every (not S2[price > 20.0] and\n"
  'e3=S3[price > 30.0])\n'
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S3', ['a', 35.0, 1], 1000),
   ('S2', ['kill', 25.0, 1], 1100),
   ('S3', ['b', 36.0, 1], 1200)]),
 ('absent_corpus:logical_absent_mid_chain_then_stage',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] ->\n"
  'not S2[vol == 2] and e3=S3[vol == 3] -> e4=S1[vol == 4]\n'
  'select e1.sym as a, e3.sym as c, e4.sym as d insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S3', ['c', 1.0, 3], 1100),
   ('S1', ['d', 1.0, 4], 1200)]),
 ('absent_corpus:timed_logical_absent_b_before_deadline',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] ->\n"
  'not S2[price > 20.0] for 1 sec and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S3', ['c', 35.0, 1], 1400),
   ('S1', ['tick', 1.0, 9], 2500)]),
 ('absent_corpus:timed_logical_absent_b_after_deadline',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] ->\n"
  'not S2[price > 20.0] for 1 sec and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000), ('S3', ['c', 35.0, 1], 2600)]),
 ('absent_corpus:timed_logical_absent_violated_by_a',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] ->\n"
  'not S2[price > 20.0] for 1 sec and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S2', ['kill', 25.0, 1], 1300),
   ('S3', ['c', 35.0, 1], 1400),
   ('S1', ['tick', 1.0, 9], 2500)]),
 ('absent_corpus:timed_logical_absent_a_after_deadline_harmless',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] ->\n"
  'not S2[price > 20.0] for 1 sec and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S2', ['late', 25.0, 1], 2200),
   ('S3', ['c', 35.0, 1], 2600)]),
 ('absent_corpus:timed_logical_absent_nonmatching_a_ignored',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] ->\n"
  'not S2[price > 20.0] for 1 sec and e3=S3[price > 30.0]\n'
  'select e1.sym as a, e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000),
   ('S2', ['low', 5.0, 1], 1200),
   ('S3', ['c', 35.0, 1], 1500),
   ('S1', ['tick', 1.0, 9], 2500)]),
 ('absent_corpus:or_seed_then_absent_killable',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->\n"
  'not S3 for 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S1', ['WSO2', 1.0, 1], 1000),
   ('S3', ['kill', 1.0, 2], 1300),
   ('S1', ['tick', 1.0, 9], 2500)]),
 ('absent_corpus:or_seed_then_absent_fires_clean',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->\n"
  'not S3 for 1 sec\n'
  'select e1.sym as a insert into Out;\n',
  'q',
  [('S2', ['viaB', 1.0, 1], 1000), ('S1', ['tick', 1.0, 9], 2500)]),
 ('absent_corpus:or_seed_then_timed_logical_absent_needs_presence',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->\n"
  'not S3[vol == 3] for 1 sec and e3=S3[vol == 4]\n'
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000), ('S1', ['tick', 1.0, 9], 2600)]),
 ('absent_corpus:or_seed_then_timed_logical_absent_killable',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->\n"
  'not S3[vol == 3] for 1 sec and e3=S3[vol == 4]\n'
  'select e3.sym as c insert into Out;\n',
  'q',
  [('S2', ['viaB', 1.0, 1], 1000),
   ('S3', ['kill', 1.0, 3], 1200),
   ('S3', ['c', 1.0, 4], 1400),
   ('S1', ['tick', 1.0, 9], 2600)]),
 ('absent_corpus:or_seed_then_logical_pair_clean',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->\n"
  'e3=S3[vol == 3] and e4=S3[vol == 4]\n'
  'select e3.sym as c, e4.sym as d insert into Out;\n',
  'q',
  [('S1', ['a', 1.0, 1], 1000), ('S3', ['c', 1.0, 3], 1100)])]
# the corpus's raise-checks: both packages refuse these apps
X5_RAISES = [('absent_corpus:absent_does_not_capture_columns',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from e1=S1 -> e2=not S2 for 1 sec\n"
  'select e1.sym as a, e2.sym as b insert into Out;\n'),
 ('absent_corpus:logical_absent_or_rejected',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from not S2[price > 20.0] or e3=S3[price > 30.0]\n"
  'select e3.sym as c insert into Out;\n'),
 ('absent_corpus:leading_timed_logical_absent_rejected',
  '@app:playback\n'
  'define stream S1 (sym string, price float, vol int);\n'
  'define stream S2 (sym string, price float, vol int);\n'
  'define stream S3 (sym string, price float, vol int);\n'
  "@info(name='q') from not S2[price > 20.0] for 1 sec and\n"
  'e3=S3[price > 30.0]\n'
  'select e3.sym as c insert into Out;\n')]

_X5_WANT = [[(1020, [(1020, ('WSO2', 'GOOG', 85.0))], [])],
 [(1002, [(1002, (1, 3))], [])],
 [(1002, [(1002, (1, 3)), (1002, (2, 3))], []), (1004, [(1004, (4, 5))], [])],
 [(1003, [(1003, ('A', 'B', 'C'))], [])],
 [(3600, [(3600, (3, 4))], [])],
 [(1003, [(1003, (5, 11, 12, 0))], [])],
 [(1001, [(1001, (1, 2))], [])],
 [(1001, [(1001, (8,))], [])],
 [(2000, [(2000, (1,))], [])],
 [],
 [(1003, [(1003, ('B', 'C'))], [])],
 [(1003, [(1003, ('A', 'K', 'B'))], [])],
 [(1001, [(1001, ('x', 'y'))], [])],
 [(1001, [(1001, ('x', 'y'))], [])],
 [(1001, [(1001, ('x', 'y'))], []), (1003, [(1003, ('p', 'q'))], [])],
 [(1002, [(1002, (10.0, 15.0))], [])],
 [(1003, [(1003, (1.0, 2.0))], [])],
 [],
 [(1001, [(1001, ('x', 'y'))], [])],
 [(1000, [(1000, ('y',))], [])],
 [],
 [(1800, [(1800, ('x',))], [])],
 [(2000, [(2000, ('x',))], [])],
 [],
 [(1004, [(1004, ('c', 'd'))], [])],
 [(1003, [(1003, ('a', 'k', 'b'))], [])],
 [(1001, [(1001, (1,))], []), (1003, [(1003, (2,))], [])],
 [(1002, [(1002, ('x', 'y', 'z'))], [])],
 [(1010, [(1010, (55.599998474121094, 55.70000076293945))], [])],
 [],
 [(1010, [(1010, (25.0, 30.0))], []), (1030, [(1030, (26.0, 55.0))], [])],
 [(1010, [(1010, (25.0, 26.0))], [])],
 [(1020, [(1020, (25.0, 26.0))], [])],
 [(1000, [(1000, (35.0,))], [])],
 [(1010, [(1010, (25.0, None, 'IBM'))], [])],
 [(1020, [(1020, (25.0, 'IBM', 'WSO2'))], [])],
 [(1020, [(1020, (25.0, 30.0)), (1020, (30.0, 30.0))], [])],
 [(1020, [(1020, ('IBM', 'GOOG', 'WSO2'))], [])],
 [(1010, [(1010, ('A', 30.0))], []), (1030, [(1030, ('A', 85.0))], [])],
 [(1000, [(1000, (None, 25.0))], []),
  (1010, [(1010, (25.0, 30.0)), (1010, (None, 30.0))], [])],
 [(1000, [(1000, (None, None, 1.0))], []),
  (1030,
   [(1030, (25.0, 30.0, 2.0)),
    (1030, (30.0, 30.0, 2.0)),
    (1030, (None, None, 2.0))],
   [])],
 [],
 [(2000, [(2000, ('WSO2',))], [])],
 [(2000, [(2000, ('WSO2',))], [])],
 [(2200, [(2200, ('a', 'b'))], [])],
 [],
 [(2400, [(2400, ('a', 'c'))], [])],
 [(2000, [(2000, ('a',))], []), (2400, [(2400, ('b',))], [])],
 [],
 [(1000, [(1000, ('ok',))], [])],
 [],
 [(1200, [(1200, ('a', 'c'))], [])],
 [],
 [],
 [(1000, [(1000, ('ok',))], [])],
 [],
 [(1000, [(1000, ('ok',))], [])],
 [(1000, [(1000, ('a',))], []), (1200, [(1200, ('b',))], [])],
 [(1200, [(1200, ('a', 'c', 'd'))], [])],
 [(2000, [(2000, ('a', 'c'))], [])],
 [(2600, [(2600, ('a', 'c'))], [])],
 [],
 [(2600, [(2600, ('a', 'c'))], [])],
 [(2000, [(2000, ('a', 'c'))], [])],
 [],
 [(2000, [(2000, (None,))], [])],
 [],
 [],
 [],
 [(1002, [(1002, (20.0, 30.0))], []),
  (1005,
   [(1005, (20.0, 31.0)), (1005, (22.0, 31.0)), (1005, (25.0, 31.0))],
   []),
  (1007, [(1007, (20.0, 29.0)), (1007, (21.0, 29.0))], []),
  (1009,
   [(1009, (20.0, 24.0)), (1009, (21.0, 24.0)), (1009, (24.0, 24.0))],
   []),
  (1011, [(1011, (21.0, 35.0)), (1011, (23.0, 35.0))], [])],
 [(1004, [(1004, (10, 0.0)), (1004, (10, 2.0)), (1004, (10, 3.0))], []),
  (1006, [(1006, (11, 0.0)), (1006, (11, 2.5))], [])],
 [(1004, [(1004, (10, 0.0)), (1004, (10, 2.0)), (1004, (10, 3.0))], []),
  (1006, [(1006, (11, 0.0)), (1006, (11, 2.5))], [])],
 [(1001, [(1001, (5, 'removed')), (1001, (6, 'removed'))], []),
  (1005, [(1005, (6, 'removed'))], [])],
 [(1001, [(1001, (5, 'removed')), (1001, (6, 'removed'))], []),
  (1005, [(1005, (6, 'removed'))], [])],
 [],
 [],
 [(1020,
   [(1020, ('WSO2', 'GOOG', 85.0)),
    (1020, ('WSO2', 'GOOG', 85.0)),
    (1020, ('WSO2', 'GOOG', 85.0))],
   [])],
 [(1002, [(1002, (1, 3)), (1002, (1, 3)), (1002, (1, 3))], [])],
 [(1002,
   [(1002, (1, 3)),
    (1002, (1, 3)),
    (1002, (1, 3)),
    (1002, (2, 3)),
    (1002, (2, 3)),
    (1002, (2, 3))],
   []),
  (1004, [(1004, (4, 5)), (1004, (4, 5)), (1004, (4, 5))], [])],
 [(1003,
   [(1003, ('A', 'B', 'C')),
    (1003, ('A', 'B', 'C')),
    (1003, ('A', 'B', 'C'))],
   [])],
 [(3600, [(3600, (3, 4)), (3600, (3, 4)), (3600, (3, 4))], [])],
 [(1003,
   [(1003, (5, 11, 12, 0)), (1003, (5, 11, 12, 0)), (1003, (5, 11, 12, 0))],
   [])],
 [(1001, [(1001, (1, 2)), (1001, (1, 2)), (1001, (1, 2))], [])],
 [(1001, [(1001, (8,)), (1001, (8,)), (1001, (8,))], [])],
 [(2000, [(2000, (1,)), (2000, (1,)), (2000, (1,))], [])],
 [],
 [(1003, [(1003, ('B', 'C')), (1003, ('B', 'C')), (1003, ('B', 'C'))], [])],
 [(1003,
   [(1003, ('A', 'K', 'B')),
    (1003, ('A', 'K', 'B')),
    (1003, ('A', 'K', 'B'))],
   [])],
 [(1001, [(1001, ('x', 'y')), (1001, ('x', 'y')), (1001, ('x', 'y'))], [])],
 [(1001, [(1001, ('x', 'y')), (1001, ('x', 'y')), (1001, ('x', 'y'))], [])],
 [(1001, [(1001, ('x', 'y')), (1001, ('x', 'y')), (1001, ('x', 'y'))], []),
  (1003, [(1003, ('p', 'q')), (1003, ('p', 'q')), (1003, ('p', 'q'))], [])],
 [(1002,
   [(1002, (10.0, 15.0)), (1002, (10.0, 15.0)), (1002, (10.0, 15.0))],
   [])],
 [(1003, [(1003, (1.0, 2.0)), (1003, (1.0, 2.0)), (1003, (1.0, 2.0))], [])],
 [],
 [(1001, [(1001, ('x', 'y')), (1001, ('x', 'y')), (1001, ('x', 'y'))], [])],
 [(1000, [(1000, ('y',)), (1000, ('y',)), (1000, ('y',))], [])],
 [],
 [(1800, [(1800, ('x',)), (1800, ('x',)), (1800, ('x',))], [])],
 [(2000, [(2000, ('x',)), (2000, ('x',)), (2000, ('x',))], [])],
 [],
 [(1004, [(1004, ('c', 'd')), (1004, ('c', 'd')), (1004, ('c', 'd'))], [])],
 [(1003,
   [(1003, ('a', 'k', 'b')),
    (1003, ('a', 'k', 'b')),
    (1003, ('a', 'k', 'b'))],
   [])],
 [(1001, [(1001, (1,)), (1001, (1,)), (1001, (1,))], []),
  (1003, [(1003, (2,)), (1003, (2,)), (1003, (2,))], [])],
 [(1002,
   [(1002, ('x', 'y', 'z')),
    (1002, ('x', 'y', 'z')),
    (1002, ('x', 'y', 'z'))],
   [])],
 [(1010,
   [(1010, (55.599998474121094, 55.70000076293945)),
    (1010, (55.599998474121094, 55.70000076293945)),
    (1010, (55.599998474121094, 55.70000076293945))],
   [])],
 [],
 [(1010,
   [(1010, (25.0, 30.0)), (1010, (25.0, 30.0)), (1010, (25.0, 30.0))],
   []),
  (1030,
   [(1030, (26.0, 55.0)), (1030, (26.0, 55.0)), (1030, (26.0, 55.0))],
   [])],
 [(1010,
   [(1010, (25.0, 26.0)), (1010, (25.0, 26.0)), (1010, (25.0, 26.0))],
   [])],
 [(1020,
   [(1020, (25.0, 26.0)), (1020, (25.0, 26.0)), (1020, (25.0, 26.0))],
   [])],
 [(1000, [(1000, (35.0,)), (1000, (35.0,)), (1000, (35.0,))], [])],
 [(1010,
   [(1010, (25.0, None, 'IBM')),
    (1010, (25.0, None, 'IBM')),
    (1010, (25.0, None, 'IBM'))],
   [])],
 [(1020,
   [(1020, (25.0, 'IBM', 'WSO2')),
    (1020, (25.0, 'IBM', 'WSO2')),
    (1020, (25.0, 'IBM', 'WSO2'))],
   [])],
 [(1020,
   [(1020, (25.0, 30.0)),
    (1020, (25.0, 30.0)),
    (1020, (25.0, 30.0)),
    (1020, (30.0, 30.0)),
    (1020, (30.0, 30.0)),
    (1020, (30.0, 30.0))],
   [])],
 [(1020,
   [(1020, ('IBM', 'GOOG', 'WSO2')),
    (1020, ('IBM', 'GOOG', 'WSO2')),
    (1020, ('IBM', 'GOOG', 'WSO2'))],
   [])],
 [(1010, [(1010, ('A', 30.0)), (1010, ('A', 30.0)), (1010, ('A', 30.0))], []),
  (1030,
   [(1030, ('A', 85.0)), (1030, ('A', 85.0)), (1030, ('A', 85.0))],
   [])],
 [(1000,
   [(1000, (None, 25.0)), (1000, (None, 25.0)), (1000, (None, 25.0))],
   []),
  (1010,
   [(1010, (25.0, 30.0)),
    (1010, (25.0, 30.0)),
    (1010, (25.0, 30.0)),
    (1010, (None, 30.0)),
    (1010, (None, 30.0)),
    (1010, (None, 30.0))],
   [])],
 [(1000,
   [(1000, (None, None, 1.0)),
    (1000, (None, None, 1.0)),
    (1000, (None, None, 1.0))],
   []),
  (1030,
   [(1030, (25.0, 30.0, 2.0)),
    (1030, (25.0, 30.0, 2.0)),
    (1030, (25.0, 30.0, 2.0)),
    (1030, (30.0, 30.0, 2.0)),
    (1030, (30.0, 30.0, 2.0)),
    (1030, (30.0, 30.0, 2.0)),
    (1030, (None, None, 2.0)),
    (1030, (None, None, 2.0)),
    (1030, (None, None, 2.0))],
   [])],
 [],
 [(2000, [(2000, ('WSO2',)), (2000, ('WSO2',)), (2000, ('WSO2',))], [])],
 [(2000, [(2000, ('WSO2',)), (2000, ('WSO2',)), (2000, ('WSO2',))], [])],
 [(2200, [(2200, ('a', 'b')), (2200, ('a', 'b')), (2200, ('a', 'b'))], [])],
 [],
 [(2400, [(2400, ('a', 'c')), (2400, ('a', 'c')), (2400, ('a', 'c'))], [])],
 [(2000, [(2000, ('a',)), (2000, ('a',)), (2000, ('a',))], []),
  (2400, [(2400, ('b',)), (2400, ('b',)), (2400, ('b',))], [])],
 [],
 [(1000, [(1000, ('ok',)), (1000, ('ok',)), (1000, ('ok',))], [])],
 [],
 [(1200, [(1200, ('a', 'c')), (1200, ('a', 'c')), (1200, ('a', 'c'))], [])],
 [],
 [],
 [(1000, [(1000, ('ok',)), (1000, ('ok',)), (1000, ('ok',))], [])],
 [],
 [(1000, [(1000, ('ok',)), (1000, ('ok',)), (1000, ('ok',))], [])],
 [(1000, [(1000, ('a',)), (1000, ('a',)), (1000, ('a',))], []),
  (1200, [(1200, ('b',)), (1200, ('b',)), (1200, ('b',))], [])],
 [(1200,
   [(1200, ('a', 'c', 'd')),
    (1200, ('a', 'c', 'd')),
    (1200, ('a', 'c', 'd'))],
   [])],
 [(2000, [(2000, ('a', 'c')), (2000, ('a', 'c')), (2000, ('a', 'c'))], [])],
 [(2600, [(2600, ('a', 'c')), (2600, ('a', 'c')), (2600, ('a', 'c'))], [])],
 [],
 [(2600, [(2600, ('a', 'c')), (2600, ('a', 'c')), (2600, ('a', 'c'))], [])],
 [(2000, [(2000, ('a', 'c')), (2000, ('a', 'c')), (2000, ('a', 'c'))], [])],
 [],
 [(2000, [(2000, (None,)), (2000, (None,)), (2000, (None,))], [])],
 [],
 [],
 [],
 [(1002,
   [(1002, (20.0, 30.0)), (1002, (20.0, 30.0)), (1002, (20.0, 30.0))],
   []),
  (1005,
   [(1005, (20.0, 31.0)),
    (1005, (20.0, 31.0)),
    (1005, (20.0, 31.0)),
    (1005, (22.0, 31.0)),
    (1005, (22.0, 31.0)),
    (1005, (22.0, 31.0)),
    (1005, (25.0, 31.0)),
    (1005, (25.0, 31.0)),
    (1005, (25.0, 31.0))],
   []),
  (1007,
   [(1007, (20.0, 29.0)),
    (1007, (20.0, 29.0)),
    (1007, (20.0, 29.0)),
    (1007, (21.0, 29.0)),
    (1007, (21.0, 29.0)),
    (1007, (21.0, 29.0))],
   []),
  (1009,
   [(1009, (20.0, 24.0)),
    (1009, (20.0, 24.0)),
    (1009, (20.0, 24.0)),
    (1009, (21.0, 24.0)),
    (1009, (21.0, 24.0)),
    (1009, (21.0, 24.0)),
    (1009, (24.0, 24.0)),
    (1009, (24.0, 24.0)),
    (1009, (24.0, 24.0))],
   []),
  (1011,
   [(1011, (21.0, 35.0)),
    (1011, (21.0, 35.0)),
    (1011, (21.0, 35.0)),
    (1011, (23.0, 35.0)),
    (1011, (23.0, 35.0)),
    (1011, (23.0, 35.0))],
   [])],
 [(1004,
   [(1004, (10, 0.0)),
    (1004, (10, 0.0)),
    (1004, (10, 0.0)),
    (1004, (10, 2.0)),
    (1004, (10, 2.0)),
    (1004, (10, 2.0)),
    (1004, (10, 3.0)),
    (1004, (10, 3.0)),
    (1004, (10, 3.0))],
   []),
  (1006,
   [(1006, (11, 0.0)),
    (1006, (11, 0.0)),
    (1006, (11, 0.0)),
    (1006, (11, 2.5)),
    (1006, (11, 2.5)),
    (1006, (11, 2.5))],
   [])],
 [(1004,
   [(1004, (10, 0.0)),
    (1004, (10, 0.0)),
    (1004, (10, 0.0)),
    (1004, (10, 2.0)),
    (1004, (10, 2.0)),
    (1004, (10, 2.0)),
    (1004, (10, 3.0)),
    (1004, (10, 3.0)),
    (1004, (10, 3.0))],
   []),
  (1006,
   [(1006, (11, 0.0)),
    (1006, (11, 0.0)),
    (1006, (11, 0.0)),
    (1006, (11, 2.5)),
    (1006, (11, 2.5)),
    (1006, (11, 2.5))],
   [])],
 [(1001,
   [(1001, (5, 'removed')),
    (1001, (5, 'removed')),
    (1001, (5, 'removed')),
    (1001, (6, 'removed')),
    (1001, (6, 'removed')),
    (1001, (6, 'removed'))],
   []),
  (1005,
   [(1005, (6, 'removed')), (1005, (6, 'removed')), (1005, (6, 'removed'))],
   [])],
 [(1001,
   [(1001, (5, 'removed')),
    (1001, (5, 'removed')),
    (1001, (5, 'removed')),
    (1001, (6, 'removed')),
    (1001, (6, 'removed')),
    (1001, (6, 'removed'))],
   []),
  (1005,
   [(1005, (6, 'removed')), (1005, (6, 'removed')), (1005, (6, 'removed'))],
   [])],
 [],
 [],
 [(1002, [(1002, ('a', 150.0, 2))], []),
  (1003, [(1003, ('b', 35.0, 2))], []),
  (1004, [(1004, ('f', 215.0, 3))], []),
  (1005, [(1005, ('i', 65.0, 3))], [])]]
X5_CASES = [spec[:4] + (want,) for spec, want in
            zip(x5_specs(), _X5_WANT)]


# ---------------------------------------------------------------------------
# slice 14: incremental aggregations (K27 agg_base, csrc/agg_base.cu; K28
# agg_merge, csrc/agg_merge.cu), named windows and triggers
# ---------------------------------------------------------------------------

AG_SYMS = 4096            # AG1's symbols
AG_B = 1 << 17            # AG1's trades a send (1 s of event time)
AG_SENDS = 160            # AG1's sends: the seconds' retention purges
AG_CAP = 1 << 20          # AG1's @capacity(buckets): 2^20 a duration
AG_PURGE, AG_SEC_KEEP = 15_000, 120_000
AGJ_LO, AGJ_HI = 100_000, 160_000   # AGJ1's `within`: AG1's last 60 s
AGJ_TIMED = 16
NW_ROOMS, NW_DEVICES, NW_B = 4096, 1 << 16, 1 << 17
NW_SENDS = 24

# the query guide's TradeAggregation (seconds to years over 4,096 symbols,
# 7 base rows) and, on its state, the guide's `within ... per` join
AG1_QL = """@app:playback
define stream TradeStream (symbol string, price double, volume long,
                           ts long);
define stream StockStream (symbol string);
@capacity(buckets='{cap}')
define aggregation TradeAggregation
from TradeStream
select symbol, avg(price) as avgPrice, sum(price) as total,
       min(price) as low, max(price) as high, sum(volume) as vol,
       count() as n
group by symbol
aggregate by ts every sec ... year;
@info(name='agj1') @emit(rows='{emit}')
from StockStream as S join TradeAggregation as T
  on S.symbol == T.symbol
  within {lo}L, {hi}L per "seconds"
select S.symbol as symbol, T.AGG_TIMESTAMP as bucket, T.total as total,
       T.n as n
insert into EnrichedTradeStream;
"""

# the guide's shared time window, its reader, and a trigger joined with it
# (each trigger's pairs projected: `max(temp) group by roomNo` over the
# window side raises in both packages, and aggregators without a group by
# would put every pair in one K4 segment)
NW1_QL = """@app:playback
define stream TempStream (roomNo int, deviceID long, temp double);
define window TempWindow (roomNo int, deviceID long, temp double)
    time(10 sec) output all events;
define trigger Tick at every 1 sec;
@info(name='ins') from TempStream select * insert into TempWindow;
@info(name='nw1') from TempWindow
select roomNo, avg(temp) as avgTemp, count() as n group by roomNo
insert into RoomStats;
@info(name='tr1') @emit(rows='2097152')
from Tick unidirectional join TempWindow
select Tick.triggered_time as t, TempWindow.roomNo as roomNo,
       TempWindow.temp as temp
insert into TickOut;
"""

# K27's edge cases: every column type, nulls of each, a filter, values of
# expressions
AGX_QL = """
define stream S (k string, i int, l long, f float, d double, b bool,
                 ts long);
define aggregation A from S[i > -100 and b]
select k, sum(i) as si, min(l) as ml, avg(f) as af, max(d * 2.0) as xd,
       sum(l + 1L) as s1, count() as n
group by k aggregate by ts every seconds, minutes, hours;
"""


def agg_modules():
    from siddhi_tpu_torch.kernels import agg_base, agg_merge
    return {"agg_base": agg_base, "agg_merge": agg_merge}


def nw_modules():
    from siddhi_tpu_torch.kernels import filter_compact, group_agg, \
        join_probe, time_window
    return {"filter_compact": filter_compact, "time_window": time_window,
            "group_agg": group_agg, "join_probe": join_probe}


def agx_batch(np, rng, B, n_valid, ev, kind=None):
    """A seeded batch over AGX_QL's stream: nulls of every type, +-inf,
    -0.0, padding rows and EXPIRED rows (or every row of `kind`)."""
    i = rng.integers(-200, 200, B).astype(np.int32)
    i[rng.random(B) < 0.1] = ev.NULL_INT
    ln = rng.integers(-2**40, 2**40, B).astype(np.int64)
    ln[rng.random(B) < 0.1] = ev.NULL_LONG
    f = rng.normal(0, 100, B).astype(np.float32)
    d = rng.normal(0, 1e6, B).astype(np.float32)
    for a in (f, d):
        a[rng.random(B) < 0.1] = np.nan
        a[rng.random(B) < 0.05] = np.inf
        a[rng.random(B) < 0.05] = -np.inf
        a[rng.random(B) < 0.05] = -0.0
    b = rng.random(B) < 0.8
    k = np.where(rng.random(B) < 0.1, ev.EXPIRED, ev.CURRENT)
    if kind is not None:
        k[:] = kind
    valid = np.arange(B) < n_valid
    ts = np.full(B, 1000, np.int64)
    return ts, k.astype(np.int32), valid, [np.zeros(B, np.int32), i, ln, f,
                                           d, b, ts]


def ag1_send(np, i, syms=AG_SYMS, B=AG_B, seed=141):
    """AG1's send i: B trades over `syms` symbols in second i, 1% null
    prices and 1% null volumes: (symbol index, price, volume, ts)."""
    from siddhi_tpu_torch.core import event as ev
    rng = np.random.default_rng(seed + i)
    sym = rng.integers(0, syms, B).astype(np.int32)
    price = (1 + 99 * rng.random(B)).astype(np.float32)
    price[rng.random(B) < 0.01] = np.nan
    vol = rng.integers(1, 1000, B).astype(np.int64)
    vol[rng.random(B) < 0.01] = ev.NULL_LONG
    ts = i * 1000 + np.sort(rng.integers(0, 1000, B)).astype(np.int64)
    return sym, price, vol, ts


class AggModel:
    """AG1's buckets in numpy: per (bucket, symbol) the base values merged
    in row order (np.add.at, np.minimum.at, np.maximum.at over each send
    in turn), for the seconds, minutes and hours durations."""

    SPANS = {"SECONDS": 1000, "MINUTES": 60_000, "HOURS": 3_600_000}

    def __init__(self, np, syms):
        self.np, self.syms = np, syms
        self.acc = {d: {} for d in self.SPANS}

    def send(self, sym, price, vol, i):
        np = self.np
        pn, vn = np.isnan(price), vol == np.iinfo(np.int64).min
        p = price.astype(np.float64)
        parts = (np.where(pn, 0.0, p), (~pn).astype(np.float64),
                 np.where(pn, np.inf, p), np.where(pn, -np.inf, p),
                 np.where(vn, 0.0, vol.astype(np.float64)),
                 (~vn).astype(np.float64))
        for dur, span in self.SPANS.items():
            key = (i * 1000 // span) * span
            a = self.acc[dur].get(key)
            if a is None:
                z = np.zeros(self.syms)
                a = self.acc[dur][key] = [z.copy(), z.copy(),
                                          np.full(self.syms, np.inf),
                                          np.full(self.syms, -np.inf),
                                          z.copy(), z.copy(), z.copy()]
            np.add.at(a[0], sym, parts[0])
            np.add.at(a[1], sym, parts[1])
            np.minimum.at(a[2], sym, parts[2])
            np.maximum.at(a[3], sym, parts[3])
            np.add.at(a[4], sym, parts[4])
            np.add.at(a[5], sym, parts[5])
            np.add.at(a[6], sym, 1.0)

    def rows(self, dur, lo=None):
        """(bucket, symbol index, avgPrice, total, low, high, vol, n) of
        every bucket of `dur` at or after `lo` that holds a row, sorted by
        (bucket, symbol)."""
        np = self.np
        out = []
        for key in sorted(self.acc[dur]):
            if lo is not None and key < lo:
                continue
            s, c, lo_, hi, vs, vc, n = self.acc[dur][key]
            m = np.nonzero(n > 0)[0]
            nan = np.float64(np.nan)
            out.append((np.full(m.shape, key, np.int64), m.astype(np.int64),
                        np.where(c > 0, s / np.maximum(c, 1), nan)[m]
                        .astype(np.float32),
                        np.where(c > 0, s, nan)[m].astype(np.float32),
                        np.where(c > 0, lo_, nan)[m].astype(np.float32),
                        np.where(c > 0, hi, nan)[m].astype(np.float32),
                        np.where(vc > 0, vs, float(np.iinfo(np.int64).min))
                        [m].astype(np.int64), n[m].astype(np.int64)))
        return [np.concatenate(x) for x in zip(*out)]


def ag_snapshot(np, agg, dur, sym_of, lo=None):
    """The port's buckets of `dur` (at or after `lo`) as AggModel.rows
    gives them: symbol ids mapped to indexes, sorted by (bucket,
    symbol)."""
    ts, cols = agg.snapshot_rows(dur, None)
    if lo is not None:
        m = ts >= lo
        ts, cols = ts[m], [c[m] for c in cols]
    sym = sym_of[cols[1]]
    o = np.lexsort((sym, ts))
    return [ts[o], sym[o].astype(np.int64)] + [c[o] for c in cols[2:]]


def ag_equal(np, torch, got, want, what):
    if [len(x) for x in got] != [len(x) for x in want]:
        fail(f"{what}: {len(got[0])} buckets, expected {len(want[0])}")
    for j, (a, b) in enumerate(zip(got, want)):
        float_err(torch, torch.from_numpy(np.ascontiguousarray(a)),
                  torch.from_numpy(np.ascontiguousarray(b)),
                  f"{what} column {j}")


def compare_agg(torch, np, dev):
    """Phase 53: K27 and K28 against their plain versions on the card from
    the same inputs (exact, NaN equal to NaN and -0.0 apart from +0.0):
    K27 on AGX_QL's plan (random rows with nulls of each type, +-inf,
    -0.0, padding and EXPIRED rows; every row filtered out; an empty
    batch; a TIMER-only batch) and on AG1's at 131,072 rows; K28 on
    random slots with -1, +-inf and -0.0, one hot slot of 4,096 rows whose
    sum depends on its order, and AG1's shapes (6 durations x 7 bases x
    2^20 buckets).  Returns (max error, AG1's K27 spec)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core import event as ev
    m = agg_modules()
    k27, k28 = m["agg_base"], m["agg_merge"]
    err = 0.0
    agx = SiddhiManager(device=dev).create_siddhi_app_runtime(
        AGX_QL).aggregations["A"]
    rng = np.random.default_rng(153)
    cases = [(AG_B, AG_B - 5, None), (AG_B, AG_B, None), (64, 0, None),
             (1024, 1024, ev.TIMER)]
    for B, nv, kind in cases:
        ts, k, valid, cols = agx_batch(np, rng, B, nv, ev, kind)
        if kind is None and nv == B:
            cols[5][:] = False                  # every row filtered out
        b = ev.StagedBatch(ts, k, valid, cols, B).to_device(agx.in_schema,
                                                            dev)
        ka, va = k27.launch(agx.spec, b)
        kb, vb = k27.plain(agx.spec, b, 1000)
        err = max(err, float_err(torch, ka, kb, f"K27 keep ({B}, {nv})"),
                  float_err(torch, va, vb, f"K27 vals ({B}, {nv})"))
    ag1 = SiddhiManager(device=dev).create_siddhi_app_runtime(
        AG1_QL.format(cap=AG_CAP, emit=1 << 18, lo=AGJ_LO, hi=AGJ_HI)
    ).aggregations["TradeAggregation"]
    sym, price, vol, ts = ag1_send(np, 0)
    b = ev.StagedBatch(ts, np.zeros(AG_B, np.int32), np.ones(AG_B, bool),
                       [sym, price, vol, ts], AG_B).to_device(
                           ag1.in_schema, dev)
    ka, va = k27.launch(ag1.spec, b)
    kb, vb = k27.plain(ag1.spec, b, 0)
    err = max(err, float_err(torch, ka, kb, "K27 keep (AG1)"),
              float_err(torch, va, vb, "K27 vals (AG1)"))

    def merge_case(D, nb, cap, slots, vals, kinds, what):
        nonlocal err
        base = torch.from_numpy(rng.normal(0, 1e3, (D, nb, cap))).to(dev)
        base[:, :, :7] = torch.tensor([np.inf, -np.inf, -0.0, 0.0, 1e16,
                                       -1e16, 1.0], dtype=torch.float64)
        a, p = base.clone(), base.clone()
        s = torch.from_numpy(slots).to(dev)
        v = torch.from_numpy(vals).to(dev)
        k28.launch(a, s, v, kinds)
        k28.plain(p, s, v, kinds)
        err = max(err, float_err(torch, a, p, f"K28 slab ({what})"))
        if not torch.equal(torch.signbit(a), torch.signbit(p)):
            fail(f"K28 slab ({what}): signs of zero differ")
    kinds = ["sum", "count", "min", "max", "sum", "min", "max"]
    B = 8192
    vals = rng.normal(0, 1e16, (7, B)) * (rng.random((7, B)) < 0.5) + \
        rng.integers(-3, 3, (7, B))
    for x, p in ((np.inf, 0.02), (-np.inf, 0.02), (-0.0, 0.05)):
        vals[rng.random((7, B)) < p] = x
    slots = rng.integers(-1, 64, (3, B)).astype(np.int32)
    merge_case(3, 7, 256, slots, vals, kinds, "random, slot -1")
    hot = np.zeros((1, 4096), np.int32)
    hv = np.tile(np.array([1.0, 1e16, 1.0, -1e16]), 1024)[None, :].repeat(
        7, 0)
    merge_case(1, 7, 16, hot, hv, kinds, "one slot, order-sensitive sum")
    merge_case(2, 7, 16, np.full((2, 0), 0, np.int32), np.zeros((7, 0)),
               kinds, "empty")
    merge_case(6, 7, AG_CAP, ag1_slots(np, 6), va.cpu().numpy(), ag1.kinds,
               "AG1 shapes")
    print(f"compare: K27 == plain on {len(cases) + 1} batches, K28 == plain "
          f"on 4 merges (AG1's at 6 x 7 x 2^20), max_abs_err {err}")
    return err, ag1, b


def ag1_slots(np, D):
    """K28's slots at an AG1 send: per duration the buckets of the send's
    4,096 symbols (32 rows each), as a steady send touches them."""
    sym = np.random.default_rng(157).integers(0, AG_SYMS, AG_B)
    return np.stack([(d * 100_003 + 17 * sym) % AG_CAP
                     for d in range(D)]).astype(np.int32)


def time_agg(torch, np, dev, ag1, batch):
    """Phase 54: K27 and K28 at AG1's shapes (CUDA-graph replays), their
    plain versions, their bounds, and as K28's library yardstick one
    `scatter_reduce_` per (base, duration)."""
    m = agg_modules()
    k27, k28 = m["agg_base"], m["agg_merge"]
    spec, kinds = ag1.spec, ag1.kinds
    res = {}
    t = {"ms": graph_ms(torch, lambda: k27.launch(spec, batch), 20),
         "plain_ms": event_timer(torch, lambda: k27.plain(spec, batch, 0),
                                 5)}
    nb = len(spec.modes)
    # kind, valid and the two loaded columns read; keep and vals written
    t.update(bound(AG_B * (4 + 1 + 4 + 8) + AG_B * (1 + 8 * nb),
                   AG_B * sum(len(c) for c in spec.vcodes)))
    t["library_ms"] = None
    res["agg_base"] = t
    _, vals = k27.launch(spec, batch)
    D = len(ag1.durations)
    slab = torch.zeros((D, nb, AG_CAP), dtype=torch.float64, device=dev)
    slots = torch.from_numpy(ag1_slots(np, D)).to(dev)
    t = {"ms": graph_ms(torch, lambda: k28.launch(slab, slots, vals, kinds),
                        20),
         "plain_ms": event_timer(torch, lambda: k28.plain(slab, slots, vals,
                                                          kinds), 3)}
    t.update(bound(D * AG_B * 4 + nb * AG_B * 8 + 2 * 8 * nb * D * AG_SYMS))
    idx = slots.to(torch.int64)
    red = {"sum": "sum", "count": "sum", "min": "amin", "max": "amax"}

    def library():
        for d in range(D):
            for b, k in enumerate(kinds):
                slab[d, b].scatter_reduce_(0, idx[d], vals[b], red[k])
    t["library_ms"] = event_timer(torch, library, 5)
    res["agg_merge"] = t
    for name, r in res.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms ({D * nb} scatter_reduce_ calls, " \
            f"one per (duration, base), in the library's own sum order)"
        print(f"kernel {name}: {r['ms']:.4f} ms at AG1's send (graph "
              f"replay), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} "
              f"bytes), library {lib}")
    return res


def run_ag1(torch, np, dev, sends=AG_SENDS, syms=AG_SYMS, B=AG_B,
            cap=AG_CAP, check=True):
    """AG1: the guide's TradeAggregation at 4,096 symbols, 160 sends of
    131,072 trades, 1 s of event time a send, 1% null prices and volumes;
    every (symbol, second) bucket the 120 s retention keeps and every
    (symbol, minute) bucket held to AggModel (f64 equal), the launches
    of K27 / K28 with the plain versions never called.  Then AGJ1 on its
    state: 16 sends of 4,096 requests joined with the last 60 s of
    seconds, each send's count and one send's rows against the model, and
    an on-demand read per "hours".  Returns the launches."""
    from siddhi_tpu_torch import SiddhiManager
    m = agg_modules()
    for mo in list(m.values()) + list(nw_modules().values()):
        mo.reset_counts()
    mgr = SiddhiManager(device=dev)
    lo, hi = (sends - 60) * 1000, sends * 1000
    rt = mgr.create_siddhi_app_runtime(AG1_QL.format(
        cap=cap, emit=1 << max(10, (60 * syms - 1).bit_length()), lo=lo,
        hi=hi))
    ids = np.array([mgr.interner.intern(f"S{j:04d}") for j in range(syms)],
                   np.int32)
    sym_of = np.zeros(int(ids.max()) + 1, np.int64)
    sym_of[ids] = np.arange(syms)
    agg = rt.aggregations["TradeAggregation"]
    joined = []
    rt.add_batch_callback("agj1", lambda ts, p: joined.append(p))
    rt.start()
    h = rt.get_input_handler("TradeStream")
    model = AggModel(np, syms)
    lat = []
    t0 = time.perf_counter()
    for i in range(sends):
        sym, price, vol, ts = ag1_send(np, i, syms, B)
        tb = time.perf_counter()
        h.send_columns([ids[sym], price, vol, ts], timestamps=ts)
        lat.append(time.perf_counter() - tb)
        if check:
            model.send(sym, price, vol, i)
    rt.flush()
    wall = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in m.items()}
    plain = {k: mo.plain_calls for k, mo in m.items()}
    check_launched("AG1", launches, plain, ("agg_base", "agg_merge"))
    lat_line(np, f"AG1 (TradeAggregation, {syms} symbols, 6 durations)",
             lat, wall, sends * B, B * (4 + 4 + 8 + 8))
    if check:
        last_purge = ((sends - 1) * 1000 + 999) // AG_PURGE * AG_PURGE
        cut = last_purge - AG_SEC_KEEP
        for dur, lo_ in (("SECONDS", cut), ("MINUTES", None)):
            ag_equal(np, torch, ag_snapshot(np, agg, dur, sym_of, lo_),
                     model.rows(dur, lo_), f"AG1 {dur}")
        n_sec = len(agg._dstores["SECONDS"].alloc)
        print(f"AG1: every (symbol, second) bucket since {cut} ms "
              f"({n_sec} buckets after the purges, slots recycled) and every "
              f"(symbol, minute) bucket equal to numpy (f64 sums in row "
              f"order)")
    # AGJ1 on AG1's state
    rh = rt.get_input_handler("StockStream")
    req = [ids]
    lat, per = [], []
    t0 = time.perf_counter()
    for j in range(AGJ_TIMED):
        tb = time.perf_counter()
        rh.send_columns(req, timestamps=np.full(syms, hi + j, np.int64))
        lat.append(time.perf_counter() - tb)
    rt.flush()
    wall = time.perf_counter() - t0
    per = [p["n_current"] for p in joined]
    want_n = min(60, sends) * syms
    if per != [want_n] * AGJ_TIMED:
        fail(f"AGJ1: joined rows a send {per}, expected {want_n}")
    if check:
        c = joined[-1]["cols"]
        v = joined[-1]["valid"]
        sym = sym_of[c["symbol"][v]]
        got = [c["bucket"][v], sym.astype(np.int64), c["total"][v],
               c["n"][v]]
        o = np.lexsort((got[1], got[0]))
        got = [x[o] for x in got]
        want = model.rows("SECONDS", lo)
        keep = want[0] < hi
        ag_equal(np, torch, got, [want[0][keep], want[1][keep],
                                  want[3][keep], want[7][keep]], "AGJ1 rows")
    lat_line(np, f"AGJ1 ({syms} requests a send joined with 60 s of "
             f"seconds)", lat, wall, AGJ_TIMED * syms, syms * (4 + 8 + 4))
    prof = device_profile(torch, rt, 2, lambda b: rh.send_columns(
        req, timestamps=np.full(syms, hi + AGJ_TIMED + b, np.int64)))
    profile_line("AGJ1", 2, prof)
    ond = rt.query('from TradeAggregation within 0L, 3600000L per "hours" '
                   'select symbol, total, n')
    if check:
        ws = model.rows("HOURS")
        got = sorted((int(sym_of[mgr.interner.intern(e.data[0])]),
                      e.data[1], e.data[2]) for e in ond)
        want = [(int(s), float(t), int(n)) for s, t, n in
                zip(ws[1], ws[3], ws[7])]
        if len(got) != len(want) or any(
                g[0] != w[0] or g[2] != w[2] or np.float32(g[1]) !=
                np.float32(w[1]) for g, w in zip(got, want)):
            fail(f"AGJ1 on-demand per hours: {got[:3]} vs {want[:3]}")
        print(f"AGJ1: {AGJ_TIMED} sends of {want_n} joined rows, the last "
              f"send's rows equal to numpy; on-demand per hours: {len(got)} "
              f"rows equal to numpy")
    extra = [ag1_send(np, sends + b, syms, B) for b in range(4)]
    prof = device_profile(torch, rt, 4, lambda b: h.send_columns(
        [ids[extra[b][0]]] + list(extra[b][1:]), timestamps=extra[b][3]))
    profile_line("AG1", 4, prof)
    mgr.shutdown()
    return launches


def nw1_send(np, j, rooms=NW_ROOMS, devices=NW_DEVICES, B=NW_B):
    """NW1's send j: B readings at ts j s, every device B / devices
    times, room = device % rooms, temp 20 + room % 10 + (j % 4) / 2."""
    dev_ = (np.arange(B) % devices).astype(np.int64)
    room = (dev_ % rooms).astype(np.int32)
    temp = (20 + room % 10 + 0.5 * (j % 4)).astype(np.float32)
    return [room, dev_, temp], np.full(B, j * 1000, np.int64)


def run_nw1(torch, np, dev, sends=NW_SENDS, rooms=NW_ROOMS,
            devices=NW_DEVICES, B=NW_B):
    """NW1 and TR1: the guide's shared time(10 sec) window fed 131,072
    readings a second (2^16 devices, 4,096 rooms), about 1.31M rows alive;
    its reader's last rows per room held to the closed form after the last
    send; a trigger every second joined with it: each trigger's pair count
    and the last trigger's pairs (each room's rows and temperatures) held
    to the closed form.  K1, K2, K4 and K7 launched, the plain versions
    never called.  Returns the launches."""
    from siddhi_tpu_torch import SiddhiManager
    mods = nw_modules()
    for mo in mods.values():
        mo.reset_counts()
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(NW1_QL)
    last, ticks = [], []
    rt.add_batch_callback("nw1", lambda ts, p: last.__setitem__(
        slice(None), [p]))
    rt.add_batch_callback("tr1", lambda ts, p: ticks.append(
        (ts, p["n_current"], p)))
    rt.start()
    h = rt.get_input_handler("TempStream")
    lat = []
    t0 = time.perf_counter()
    for j in range(1, sends + 1):
        cols, ts = nw1_send(np, j, rooms, devices, B)
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        lat.append(time.perf_counter() - tb)
    rt.flush()
    wall = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    check_launched("NW1 / TR1", launches, plain, tuple(mods))
    lat_line(np, f"NW1 (time(10 sec) named window, {rooms} rooms, "
             f"{devices} devices) with TR1", lat, wall, sends * B,
             B * (4 + 8 + 4 + 8))
    # the reader's last row of each room: the window after the last send
    p = last[0]
    c, v = p["cols"], p["valid"]
    cur = v & (p["kind"] == 0)
    room, avg, n = c["roomNo"][cur], c["avgTemp"][cur], c["n"][cur]
    idx = np.zeros(rooms, np.int64)
    np.maximum.at(idx, room, np.arange(room.shape[0]))  # each room's last
    alive = range(max(1, sends - 9), sends + 1)
    per = B // rooms
    r = np.arange(rooms)
    exp_n = per * len(alive)
    exp_avg = sum(20 + r % 10 + 0.5 * (j % 4) for j in alive) / len(alive)
    got_avg = avg[idx].astype(np.float64)
    if not np.array_equal(n[idx], np.full(rooms, exp_n)) or \
            np.abs(got_avg - exp_avg).max() > 1e-6 * exp_avg.max():
        fail(f"NW1 reader: counts {n[idx][:4]}, avg {got_avg[:4]}, "
             f"expected {exp_n}, {exp_avg[:4]}")
    for ts_, nc, pay in ticks:
        T = ts_ // 1000
        # the window's expiry at T runs first (its timer entry for T is
        # older than the trigger's): sends T - 9 .. T - 1 are alive
        alive = [j for j in range(1, sends + 1) if T - 9 <= j <= T - 1]
        if nc != len(alive) * B:
            fail(f"TR1 trigger at {ts_}: {nc} pairs, expected "
                 f"{len(alive) * B}")
    T = ticks[-1][0]
    alive = [j for j in range(1, sends + 1)
             if T // 1000 - 9 <= j <= T // 1000 - 1]
    c, v = ticks[-1][2]["cols"], ticks[-1][2]["valid"]
    room, temp = c["roomNo"][v].astype(np.int64), c["temp"][v]
    cnt = np.bincount(room, minlength=rooms)
    tsum = np.bincount(room, weights=temp.astype(np.float64),
                       minlength=rooms)
    want = sum(20 + r % 10 + 0.5 * (j % 4) for j in alive) * per
    if not (np.all(c["t"][v] == T) and np.array_equal(
            cnt, np.full(rooms, per * len(alive))) and
            np.array_equal(tsum, want)):
        fail(f"TR1 trigger at {T}: pairs per room {cnt[:4]}, temp sums "
             f"{tsum[:4]}, expected {per * len(alive)}, {want[:4]}")
    # TR1's K7 launch over one trigger row: of each alive window row the
    # probe reads its alive flag and the two columns the select takes
    # (roomNo, temp), and it writes one pair row a match (ts, kind, valid,
    # t, roomNo, temp)
    nb = ticks[-1][1] * ((1 + 4 + 8) + (8 + 4 + 1 + 8 + 4 + 8))
    kb = bound(nb)
    print(f"TR1: K7's grid over one trigger row ({ticks[-1][1]} pairs from "
          f"a {ticks[-1][1]}-row window): bound {kb['bound_ms']:.5f} ms by "
          f"{kb['bound_by']} ({kb['bytes']} bytes)")
    print(f"NW1: each room's avg and count after the last send equal to the "
          f"closed form ({exp_n} rows a room, "
          f"{rt.named_windows['TempWindow'].state.C}-row ring); TR1: "
          f"{len(ticks)} triggers, {ticks[-1][1]} pairs the last, every "
          f"trigger's pair count and the last one's rows per room equal to "
          f"the closed form")
    t = time_nw1_step(torch, np, rt, sends + 1, rooms, devices, B)
    print(f"NW1: the named window's steady step (K1 + K2: {B} arrivals, "
          f"{B} expiring, {9 * B} kept) {t['ms']:.4f} ms (CUDA events, "
          f"from a restored ring), plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
          f"bytes)")
    prof = device_profile(torch, rt, 4, lambda b: h.send_columns(
        *nw1_send(np, sends + 1 + b, rooms, devices, B)))
    profile_line("NW1 / TR1", 4, prof)
    mgr.shutdown()
    return launches


def time_nw1_step(torch, np, rt, j, rooms, devices, B):
    """The named window's step on send j (K1 + K2, from a copy of the ring
    the last send left, restored outside the timed calls), its plain
    versions', and the bytes it must move: the arrivals read and written
    into the ring, the expiring rows read, the output rows written."""
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.window import BatchFacts, Rows
    from siddhi_tpu_torch.kernels import filter_compact as fc
    from siddhi_tpu_torch.kernels import time_window as tw
    nw = rt.named_windows["TempWindow"]
    snap = nw.state.clone()
    cols, ts = nw1_send(np, j, rooms, devices, B)
    staged = ev.StagedBatch(ts, np.zeros(B, np.int32), np.ones(B, bool),
                            cols, B)
    batch = staged.to_device(nw.schema, nw.device)
    facts = BatchFacts(ts, B, staged, staged.valid)
    rows = Rows(ts=batch.ts, kind=batch.kind, valid=batch.valid, seq=None,
                gslot=torch.zeros(B, dtype=torch.int32, device=nw.device),
                cols=batch.cols)
    box = {}

    def restore():
        box["st"] = snap.clone()
    restore()                  # event_timer's warm call comes first

    def step():
        nw.wproc.process(box["st"], rows, nw._fspec, j * 1000, facts)
    res = {"ms": event_timer(torch, step, 5, restore)}
    launches = fc.launch, tw.launch
    fc.launch = lambda spec, ts, kind, valid, gslot, cols, seq=None, \
        keep_expired=False, aligned=False: fc.plain(
            spec, ts, kind, valid, gslot, cols, 0, seq, keep_expired, aligned)
    tw.launch = lambda st, arr, n_arr, now, t, b, cap_out, e_bound, *_: \
        tw.plain(st, arr, n_arr, now, t, b, cap_out, e_bound)
    try:
        res["plain_ms"] = event_timer(torch, step, 3, restore)
    finally:
        fc.launch, tw.launch = launches
    row = 8 + sum(c.element_size() for c in batch.cols)   # ts and columns
    # arrivals in (kind, valid, gslot too) and into the ring (add_seq,
    # expire_ts, gslot too), expiring rows out of it, 2B output rows
    # (kind, valid, seq, gslot too)
    res.update(bound(B * (row + 9) + 2 * B * (row + 20) +
                     2 * B * (row + 17)))
    return res


def nw_run(mgr, ql, queries, sends, reads=(), window_cb=None):
    """One small named-window case: each named query's callbacks as (now,
    [(ts, current row)], [(ts, expired row)]), the window's stream
    callback batches and the on-demand results' rows."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {q: [] for q in queries}
    for q in queries:
        rt.add_callback(q, lambda ts, i, o, _q=q: got[_q].append(
            (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
             [(e.timestamp, tuple(e.data)) for e in o or []])))
    seen = []
    if window_cb is not None:
        rt.add_callback(window_cb, lambda evs: seen.append(
            [(e.timestamp, tuple(e.data)) for e in evs]))
    rt.start()
    for stream, rows, ts in sends:
        rt.get_input_handler(stream).send(rows, timestamp=ts)
    rt.flush()
    ond = [[tuple(e.data) for e in rt.query(q)] for q in reads]
    mgr.shutdown()
    return got, seen, ond


def run_x14(torch, np, dev):
    """Phase 56: X14 (every window kind as a named window, read, joined
    and read on demand) against the JAX package's events, and the
    bidirectional named-window join on the card against its plain run
    (the same app on the CPU, every step a plain version)."""
    from siddhi_tpu_torch import SiddhiManager
    for name, ql, queries, sends, reads, want in X14_CASES:
        got = nw_run(SiddhiManager(device=dev), ql, queries, sends, reads,
                     "W")
        if got != want:
            fail(f"X14 {name}: {got}, expected {want}")
    bidir = X14_JOIN_QL.format(uni="")
    a = nw_run(SiddhiManager(device=dev), bidir, ["q"], X14_JOIN_SENDS)
    b = nw_run(SiddhiManager(device="cpu"), bidir, ["q"], X14_JOIN_SENDS)
    if a != b:
        fail(f"bidirectional named-window join: card {a}, plain {b}")
    print(f"X14: {len(X14_CASES)} cases give the JAX package's events; the "
          f"bidirectional named-window join on the card equals its plain "
          f"run ({sum(len(c) for _, c, _ in a[0]['q'])} pairs)")


def slice14_phases(torch, np, dev):
    """Phases 53-56: K27 and K28 against their plain versions, their
    times, AG1 / AGJ1 and NW1 / TR1 through SiddhiManager, X14.  Returns
    the K27 and K28 kernel records."""
    t0 = time.perf_counter()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 14 {what}: {time.perf_counter() - t0:.1f} s")
    err, ag1, batch = compare_agg(torch, np, dev)
    took("phase 53 done")
    res = time_agg(torch, np, dev, ag1, batch)
    del ag1, batch
    took("phase 54 done")
    launches = run_ag1(torch, np, dev)
    took("AG1 / AGJ1 done")
    run_nw1(torch, np, dev)
    took("NW1 / TR1 done")
    run_x14(torch, np, dev)
    took("phase 56 done")
    replaces = {"agg_base": "siddhi_tpu/core/aggregation.py:483",
                "agg_merge": "siddhi_tpu/core/aggregation.py:510"}
    return [{"name": k, "route": "cuda",
             "source": f"siddhi_tpu_torch/csrc/{k}.cu",
             "replaces": replaces[k], "launches": launches[k],
             "max_abs_err": err, "ms": res[k]["ms"],
             "plain_ms": res[k]["plain_ms"], "bound_ms": res[k]["bound_ms"],
             "bound_by": res[k]["bound_by"],
             "library_ms": res[k]["library_ms"]} for k in replaces]


# X14: every window kind the JAX package probes as a named window (cron,
# whose named window the JAX package never flushes, is held apart in the
# CPU tests), read by a grouped reader, probed by a unidirectional join and
# read on demand, and the named-window join apps of
# tests/test_named_window_join.py; _X14_WANT holds the JAX package's
# events (nw_run), recomputed for some cases by the CPU tests.
X14_KIND_QL = """@app:playback
define stream In (k string, v int, ts long);
define stream Req (k string);
define window W (k string, v int, ts long) {kind} output all events;
@info(name='ins') from In select * insert into W;
@info(name='r') from W select k, sum(v) as s, count() as n group by k
insert into R;
"""
X14_KIND_JOIN = """
@info(name='j') from Req unidirectional join W on Req.k == W.k
select W.k as k, W.v as v, W.ts as ts insert into J;
"""
X14_KIND_SENDS = [
    ("In", [["a", 1, 1000], ["b", 2, 1000]], 1000),
    ("In", [["a", 3, 1500]], 1500),
    ("Req", [["a"], ["b"]], 1600),
    ("In", [["b", 4, 2100], ["a", 5, 2200], ["a", 6, 1900]], 2200),
    ("Req", [["a"]], 2300),
    ("In", [["c", 7, 3600]], 3600),
    ("Req", [["a"], ["b"], ["c"]], 3700),
    ("In", [["a", 8, 5200], ["c", 2, 5200]], 5200),
    ("Req", [["a"], ["c"]], 5300),
]
X14_READS = ["from W select *", "from W on v > 2 select k, v",
             "from W select k, count() as n group by k"]
X14_KINDS = ["length(3)", "time(1 sec)", "lengthBatch(3)",
             "timeBatch(1 sec)", "externalTime(ts, 1 sec)",
             "externalTimeBatch(ts, 1 sec)", "timeLength(1 sec, 3)",
             "delay(1 sec)", "batch()", "sort(3, v, 'asc')",
             "session(1 sec)", "hopping(2 sec, 1 sec)",
             "expression('count() <= 3')",
             "expressionBatch('count() <= 3')"]
X14_JOIN_QL = """@app:playback
define stream S (sym string, qty int);
define stream F (sym string, price double);
define window W (sym string, price double) length(8);
@info(name='feed') from F select sym, price insert into W;
@info(name='q')
from S#window.length(8) {uni} join W on S.sym == W.sym
select S.sym as sym, qty, price insert into Out;
"""
X14_JOIN_SENDS = [("S", [["a", 5]], 1000), ("F", [["a", 9.5]], 1001),
                  ("S", [["a", 6], ["b", 1]], 1002),
                  ("F", [["a", 2.0], ["b", 3.0]], 1003),
                  ("S", [["a", 3]], 1004), ("F", [["b", 1.0]], 1005)]
X14_TABLE_QL = """@app:playback
define stream F (sym string, price double);
define table T (sym string, fee double);
define stream TI (sym string, fee double);
@info(name='tw') from TI insert into T;
define window W (sym string, price double) length(8);
@info(name='feed') from F select sym, price insert into W;
@info(name='q')
from W join T on W.sym == T.sym
select W.sym as sym, price, fee insert into Out;
"""
_X14_SPECS = [(kind, X14_KIND_QL.format(kind=kind) + X14_KIND_JOIN,
               ["r", "j"], X14_KIND_SENDS, X14_READS)
              for kind in X14_KINDS] + [
    ("bidirectional join", X14_JOIN_QL.format(uni=""), ["q"],
     X14_JOIN_SENDS, ["from W select *"]),
    ("unidirectional join", X14_JOIN_QL.format(uni="unidirectional"),
     ["q"], X14_JOIN_SENDS, ()),
    ("window joins a table", X14_TABLE_QL, ["q"],
     [("TI", [["a", 0.5], ["b", 0.25]], 999),
      ("F", [["a", 10.0], ["c", 1.0]], 1000), ("F", [["b", 4.0]], 1001)],
     ["from W on price > 2.0 select sym, price"])]

_X14_WANT = [({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))], []),
         (3700,
          [(3700, ('a', 5, 2200)), (3700, ('a', 6, 1900)),
           (3700, ('c', 7, 3600))],
          []),
         (5300,
          [(5300, ('a', 8, 5200)), (5300, ('c', 7, 3600)),
           (5300, ('c', 2, 5200))],
          [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2200,
          [(2200, ('b', 6, 2)), (2200, ('a', 8, 2)), (2200, ('a', 11, 2))],
          [(1000, ('a', 3, 1)), (1000, ('b', 4, 1)), (1500, ('a', 5, 1))]),
         (3600, [(3600, ('c', 7, 1))], [(2200, ('b', None, 0))]),
         (5200, [(5200, ('a', 14, 2)), (5200, ('c', 9, 2))],
          [(2200, ('a', 6, 1)), (2200, ('a', 8, 1))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(1000, ('a', 1, 1000)), (2200, ('b', 4, 2100)), (1000, ('b', 2, 1000)),
    (2200, ('a', 5, 2200)), (1500, ('a', 3, 1500)), (2200, ('a', 6, 1900))],
   [(2200, ('b', 4, 2100)), (3600, ('c', 7, 3600))],
   [(2200, ('a', 5, 2200)), (5200, ('a', 8, 5200)), (2200, ('a', 6, 1900)),
    (5200, ('c', 2, 5200))]],
  [[('c', 7, 3600), ('a', 8, 5200), ('c', 2, 5200)], [('c', 7), ('a', 8)],
   [('a', 1), ('c', 2)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300,
          [(2300, ('a', 3, 1500)), (2300, ('a', 5, 2200)),
           (2300, ('a', 6, 1900))],
          []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2000, [], [(2000, ('a', 3, 1)), (2000, ('b', None, 0))]),
         (2200,
          [(2200, ('b', 4, 1)), (2200, ('a', 8, 2)), (2200, ('a', 14, 3))],
          []),
         (2500, [], [(2500, ('a', 11, 2))]),
         (3200, [],
          [(3200, ('b', None, 0)), (3200, ('a', 6, 1)),
           (3200, ('a', None, 0))]),
         (3600, [(3600, ('c', 7, 1))], []),
         (4600, [], [(4600, ('c', None, 0))]),
         (5200, [(5200, ('a', 8, 1)), (5200, ('c', 2, 1))], [])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(2000, ('a', 1, 1000)), (2000, ('b', 2, 1000))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(2500, ('a', 3, 1500))],
   [(3200, ('b', 4, 2100)), (3200, ('a', 5, 2200)), (3200, ('a', 6, 1900))],
   [(3600, ('c', 7, 3600))], [(4600, ('c', 7, 3600))],
   [(5200, ('a', 8, 5200)), (5200, ('c', 2, 5200))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(3700, [(3700, ('c', 7, 3600))], [])],
   'r': [(1500,
          [(1000, ('a', 1, 1)), (1000, ('b', 2, 1)), (1500, ('a', 4, 2))],
          []),
         (2200,
          [(2200, ('b', 4, 1)), (2200, ('a', 5, 1)), (2200, ('a', 11, 2))],
          [(1000, ('a', 3, 1)), (1000, ('b', None, 0)),
           (1500, ('a', None, 0))]),
         (5200,
          [(3600, ('c', 7, 1)), (5200, ('a', 8, 1)), (5200, ('c', 9, 2))],
          [(2200, ('b', None, 0)), (2200, ('a', 6, 1)),
           (2200, ('a', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (3600, ('c', 7, 3600)), (5200, ('a', 8, 5200)), (5200, ('c', 2, 5200))]],
  [[], [], []]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))], []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(2000,
          [(1000, ('a', 1, 1)), (1000, ('b', 2, 1)), (1500, ('a', 4, 2))],
          []),
         (3000,
          [(2200, ('b', 4, 1)), (2200, ('a', 5, 1)), (2200, ('a', 11, 2))],
          [(1000, ('a', 3, 1)), (1000, ('b', None, 0)),
           (1500, ('a', None, 0))]),
         (4000, [(3600, ('c', 7, 1))],
          [(2200, ('b', None, 0)), (2200, ('a', 6, 1)),
           (2200, ('a', None, 0))]),
         (5000, [], [(3600, ('c', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (3600, ('c', 7, 3600))],
   [(3600, ('c', 7, 3600))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300,
          [(2300, ('a', 3, 1500)), (2300, ('a', 6, 1900)),
           (2300, ('a', 5, 2200))],
          []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2200,
          [(2200, ('a', 10, 3)), (2200, ('b', 4, 1)), (2200, ('a', 14, 3))],
          [(2000, ('a', 9, 2)), (2000, ('b', None, 0))]),
         (3600, [(3600, ('c', 7, 1))],
          [(2500, ('a', 11, 2)), (2900, ('a', 5, 1)), (3100, ('b', None, 0)),
           (3200, ('a', None, 0))]),
         (5200, [(5200, ('a', 8, 1)), (5200, ('c', 2, 1))],
          [(4600, ('c', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(2200, ('a', 6, 1900)), (2000, ('a', 1, 1000)), (2000, ('b', 2, 1000)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200))],
   [(2500, ('a', 3, 1500)), (2900, ('a', 6, 1900)), (3100, ('b', 4, 2100)),
    (3200, ('a', 5, 2200)), (3600, ('c', 7, 3600))],
   [(4600, ('c', 7, 3600)), (5200, ('a', 8, 5200)), (5200, ('c', 2, 5200))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 5, 2200))], []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(2200,
          [(1000, ('a', 1, 1)), (1000, ('b', 2, 1)), (1500, ('a', 4, 2)),
           (2200, ('a', 10, 3))],
          []),
         (3600, [(2200, ('b', 4, 1)), (2200, ('a', 5, 1))],
          [(1000, ('a', 9, 2)), (1000, ('b', None, 0)), (1500, ('a', 6, 1)),
           (2200, ('a', None, 0))]),
         (5200, [(3600, ('c', 7, 1))],
          [(2200, ('b', None, 0)), (2200, ('a', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('a', 6, 1900))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('a', 6, 1900)), (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (3600, ('c', 7, 3600))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))], []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2000, [], [(2000, ('a', 3, 1)), (2000, ('b', None, 0))]),
         (2200,
          [(2200, ('b', 4, 1)), (2200, ('a', 5, 1)), (2200, ('a', 11, 2))],
          [(2200, ('a', None, 0))]),
         (3200, [],
          [(3200, ('b', None, 0)), (3200, ('a', 6, 1)),
           (3200, ('a', None, 0))]),
         (3600, [(3600, ('c', 7, 1))], []),
         (4600, [], [(4600, ('c', None, 0))]),
         (5200, [(5200, ('a', 8, 1)), (5200, ('c', 2, 1))], [])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(2000, ('a', 1, 1000)), (2000, ('b', 2, 1000))],
   [(2200, ('a', 3, 1500)), (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)),
    (2200, ('a', 6, 1900))],
   [(3200, ('b', 4, 2100)), (3200, ('a', 5, 2200)), (3200, ('a', 6, 1900))],
   [(3600, ('c', 7, 3600))], [(4600, ('c', 7, 3600))],
   [(5200, ('a', 8, 5200)), (5200, ('c', 2, 5200))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300,
          [(2300, ('a', 3, 1500)), (2300, ('a', 5, 2200)),
           (2300, ('a', 6, 1900))],
          []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(2000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (2500, [(1500, ('a', 4, 2))], []),
         (3200,
          [(2200, ('b', 6, 2)), (2200, ('a', 9, 3)), (2200, ('a', 15, 4))],
          []),
         (4600, [(3600, ('c', 7, 1))], [])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(3600, ('c', 7, 3600))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600, [(1600, ('a', 3, 1500))], []),
         (2300, [(2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))], []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 3, 1))],
          [(1000, ('a', None, 0)), (1000, ('b', None, 0))]),
         (2200,
          [(2200, ('b', 4, 1)), (2200, ('a', 5, 1)), (2200, ('a', 11, 2))],
          [(1500, ('a', None, 0))]),
         (3600, [(3600, ('c', 7, 1))],
          [(2200, ('b', None, 0)), (2200, ('a', 6, 1)),
           (2200, ('a', None, 0))]),
         (5200, [(5200, ('a', 8, 1)), (5200, ('c', 2, 1))],
          [(3600, ('c', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500))],
   [(1500, ('a', 3, 1500)), (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)),
    (2200, ('a', 6, 1900))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (3600, ('c', 7, 3600))],
   [(3600, ('c', 7, 3600)), (5200, ('a', 8, 5200)), (5200, ('c', 2, 5200))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 1, 1000)), (2300, ('a', 3, 1500))], []),
         (3700,
          [(3700, ('a', 1, 1000)), (3700, ('a', 3, 1500)),
           (3700, ('b', 2, 1000))],
          []),
         (5300, [(5300, ('a', 1, 1000)), (5300, ('c', 2, 5200))], [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2200,
          [(2200, ('b', 6, 2)), (2200, ('a', 9, 3)), (2200, ('a', 15, 4))],
          [(2200, ('b', 2, 1)), (2200, ('a', 10, 3)), (2200, ('a', 4, 2))]),
         (3600, [(3600, ('c', 7, 1))], [(3600, ('c', None, 0))]),
         (5200, [(5200, ('a', 12, 3)), (5200, ('c', 2, 1))],
          [(1500, ('a', 9, 2)), (5200, ('a', 1, 1))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(3600, ('c', 7, 3600)), (3600, ('c', 7, 3600))],
   [(5200, ('a', 8, 5200)), (5200, ('c', 2, 5200)), (1500, ('a', 3, 1500)),
    (5200, ('a', 8, 5200))]],
  [[('a', 1, 1000), ('b', 2, 1000), ('c', 2, 5200)], [],
   [('a', 1), ('b', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300,
          [(2300, ('a', 1, 1000)), (2300, ('a', 3, 1500)),
           (2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))],
          []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300, [(5300, ('a', 8, 5200)), (5300, ('c', 2, 5200))], [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2200,
          [(2200, ('b', 6, 2)), (2200, ('a', 9, 3)), (2200, ('a', 15, 4))],
          []),
         (3200, [],
          [(1000, ('a', 14, 3)), (1000, ('b', 4, 1)), (1500, ('a', 11, 2)),
           (2200, ('b', None, 0)), (2200, ('a', 6, 1)),
           (2200, ('a', None, 0))]),
         (3600, [(3600, ('c', 7, 1))], []),
         (4600, [], [(3600, ('c', None, 0))]),
         (5200, [(5200, ('a', 8, 1)), (5200, ('c', 2, 1))], [])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(3600, ('c', 7, 3600))], [(3600, ('c', 7, 3600))],
   [(5200, ('a', 8, 5200)), (5200, ('c', 2, 5200))]],
  [[('a', 8, 5200), ('c', 2, 5200)], [('a', 8)], [('a', 1), ('c', 1)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300,
          [(2300, ('a', 1, 1000)), (2300, ('a', 3, 1500)),
           (2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))],
          []),
         (3700,
          [(3700, ('a', 1, 1000)), (3700, ('a', 3, 1500)),
           (3700, ('a', 5, 2200)), (3700, ('a', 6, 1900)),
           (3700, ('b', 2, 1000)), (3700, ('b', 4, 2100)),
           (3700, ('c', 7, 3600))],
          []),
         (5300,
          [(5300, ('a', 8, 5200)), (5300, ('c', 7, 3600)),
           (5300, ('c', 2, 5200))],
          [])],
   'r': [(2000,
          [(1000, ('a', 1, 1)), (1000, ('b', 2, 1)), (1500, ('a', 4, 2))],
          []),
         (3000,
          [(1000, ('a', 1, 1)), (1000, ('b', 2, 1)), (1500, ('a', 4, 2)),
           (2200, ('b', 6, 2)), (2200, ('a', 9, 3)), (2200, ('a', 15, 4))],
          [(1000, ('a', 3, 1)), (1000, ('b', None, 0)),
           (1500, ('a', None, 0))]),
         (4000,
          [(2200, ('b', 4, 1)), (2200, ('a', 5, 1)), (2200, ('a', 11, 2)),
           (3600, ('c', 7, 1))],
          [(1000, ('a', 14, 3)), (1000, ('b', 4, 1)), (1500, ('a', 11, 2)),
           (2200, ('b', None, 0)), (2200, ('a', 6, 1)),
           (2200, ('a', None, 0))]),
         (5000, [(3600, ('c', 7, 1))],
          [(2200, ('b', None, 0)), (2200, ('a', 6, 1)), (2200, ('a', None, 0)),
           (3600, ('c', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (3600, ('c', 7, 3600))],
   [(2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900)),
    (3600, ('c', 7, 3600)), (3600, ('c', 7, 3600))]],
  [[('c', 7, 3600), ('a', 8, 5200), ('c', 2, 5200)], [('c', 7), ('a', 8)],
   [('a', 1), ('c', 2)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))], []),
         (3700,
          [(3700, ('a', 5, 2200)), (3700, ('a', 6, 1900)),
           (3700, ('c', 7, 3600))],
          []),
         (5300,
          [(5300, ('a', 8, 5200)), (5300, ('c', 7, 3600)),
           (5300, ('c', 2, 5200))],
          [])],
   'r': [(1000, [(1000, ('a', 1, 1)), (1000, ('b', 2, 1))], []),
         (1500, [(1500, ('a', 4, 2))], []),
         (2200,
          [(2200, ('b', 6, 2)), (2200, ('a', 8, 2)), (2200, ('a', 11, 2))],
          [(1000, ('a', 3, 1)), (1000, ('b', 4, 1)), (1500, ('a', 5, 1))]),
         (3600, [(3600, ('c', 7, 1))], [(2200, ('b', None, 0))]),
         (5200, [(5200, ('a', 14, 2)), (5200, ('c', 9, 2))],
          [(2200, ('a', 6, 1)), (2200, ('a', 8, 1))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000))], [(1500, ('a', 3, 1500))],
   [(1000, ('a', 1, 1000)), (2200, ('b', 4, 2100)), (1000, ('b', 2, 1000)),
    (2200, ('a', 5, 2200)), (1500, ('a', 3, 1500)), (2200, ('a', 6, 1900))],
   [(2200, ('b', 4, 2100)), (3600, ('c', 7, 3600))],
   [(2200, ('a', 5, 2200)), (5200, ('a', 8, 5200)), (2200, ('a', 6, 1900)),
    (5200, ('c', 2, 5200))]],
  [[('c', 7, 3600), ('a', 8, 5200), ('c', 2, 5200)], [('c', 7), ('a', 8)],
   [('a', 1), ('c', 2)]]),
 ({'j': [(1600,
          [(1600, ('a', 1, 1000)), (1600, ('a', 3, 1500)),
           (1600, ('b', 2, 1000))],
          []),
         (2300, [(2300, ('a', 5, 2200)), (2300, ('a', 6, 1900))], []),
         (3700, [(3700, ('c', 7, 3600))], []),
         (5300,
          [(5300, ('a', 8, 5200)), (5300, ('c', 7, 3600)),
           (5300, ('c', 2, 5200))],
          [])],
   'r': [(2200,
          [(1000, ('a', 1, 1)), (1000, ('b', 2, 1)), (1500, ('a', 4, 2))],
          []),
         (3600,
          [(2200, ('b', 4, 1)), (2200, ('a', 5, 1)), (2200, ('a', 11, 2))],
          [(1000, ('a', 3, 1)), (1000, ('b', None, 0)),
           (1500, ('a', None, 0))])]},
  [[(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500))],
   [(1000, ('a', 1, 1000)), (1000, ('b', 2, 1000)), (1500, ('a', 3, 1500)),
    (2200, ('b', 4, 2100)), (2200, ('a', 5, 2200)), (2200, ('a', 6, 1900))]],
  [[('c', 7, 3600), ('a', 8, 5200), ('c', 2, 5200)], [('c', 7), ('a', 8)],
   [('a', 1), ('c', 2)]]),
 ({'q': [(1001, [(1001, ('a', 5, 9.5))], []),
         (1002, [(1002, ('a', 6, 9.5))], []),
         (1003,
          [(1003, ('a', 5, 2.0)), (1003, ('a', 6, 2.0)),
           (1003, ('b', 1, 3.0))],
          []),
         (1004, [(1004, ('a', 3, 9.5)), (1004, ('a', 3, 2.0))], []),
         (1005, [(1005, ('b', 1, 1.0))], [])]},
  [[(1001, ('a', 9.5))], [(1003, ('a', 2.0)), (1003, ('b', 3.0))],
   [(1005, ('b', 1.0))]],
  [[('a', 9.5), ('a', 2.0), ('b', 3.0), ('b', 1.0)]]),
 ({'q': [(1002, [(1002, ('a', 6, 9.5))], []),
         (1004, [(1004, ('a', 3, 9.5)), (1004, ('a', 3, 2.0))], [])]},
  [[(1001, ('a', 9.5))], [(1003, ('a', 2.0)), (1003, ('b', 3.0))],
   [(1005, ('b', 1.0))]],
  []),
 ({'q': [(1000, [(1000, ('a', 10.0, 0.5))], []),
         (1001, [(1001, ('b', 4.0, 0.25))], [])]},
  [[(1000, ('a', 10.0)), (1000, ('c', 1.0))], [(1001, ('b', 4.0))]],
  [[('a', 10.0), ('b', 4.0)]])]
X14_CASES = [spec + (want,) for spec, want in zip(_X14_SPECS, _X14_WANT)]


# ---------------------------------------------------------------------------
# slice 15 (phases 57-62): the dispatch layer (A12).  K29 multi_filter, the
# stacked mode of pattern_step and K30 ring against their plain versions at
# MD1's and FP1's shapes and on PMC's plan with PM1's trades, then MD1
# (merged and unmerged), FP1 (fused and unfused), PM1 and PMC (fused), SV1
# (MD1 served) and FP1 under @pipeline(depth='4') and @async through
# SiddhiManager
# ---------------------------------------------------------------------------

MD_B = 1 << 17            # MD1's transactions a send
# MD1's accounts: 65,536 in the configuration, cut to 4,096, the group slots a
# top-level group by holds in both packages (no annotation raises it)
MD_ACCTS = 1 << 12
MD_WARM, MD_SENDS = 2, 16  # MD1's warm and timed sends
FP_B = 1 << 17            # FP1's readings a send
FP_DEVICES = 1 << 16      # FP1's devices
FP_SENDS = 32             # FP1's sends: four full stacks of 8
PM_B = 1 << 10            # PM1's trades a send
PM_SENDS = 32             # PM1's sends: four full stacks of 8
PM_SYMS = 64
MD_CHECK = (MD_WARM, MD_WARM + MD_SENDS - 1)   # sends held to numpy

MD_QUERIES = ("largeTxnAlert", "regionAudit", "spendTotal", "spendPeak",
              "spendCount", "slowBurn")
FP_QUERIES = ("fusedClean", "alerts")


def md1_ql(extra_app=""):
    """MD1: samples/apps/mqo_dashboard.siddhi in playback, slowBurn's time
    window sized to hold every row of the run (its 5 minutes span the
    whole run, so none expires)."""
    with open("samples/apps/mqo_dashboard.siddhi") as fh:
        ql = fh.read()
    rows = (MD_WARM + MD_SENDS + 4) * MD_B
    ql = ql.replace("@info(name='slowBurn')",
                    f"@capacity(window='{rows}') @info(name='slowBurn')")
    return "@app:playback\n" + extra_app + ql


def fp1_ql(deco="@fuse(batches='8')"):
    with open("samples/apps/fused_pipeline.siddhi") as fh:
        ql = fh.read()
    return "@app:playback\n" + ql.replace("@fuse(batches='8')", deco)


def pm1_ql(deco="@fuse(batches='8')"):
    with open("samples/apps/pattern_matching.siddhi") as fh:
        ql = fh.read()
    return "@app:playback\n" + ql.replace("@info(name='riseQuery')",
                                          f"{deco} @info(name='riseQuery')")


# PMC: a top-level count pattern off the block NFA (the stacked mode's path)
PMC_QL = """@app:playback
define stream StockStream (symbol string, price float);
{deco} @info(name='riseQuery')
from every e1=StockStream[price > 50.0]<2:3>
  -> e2=StockStream[price > e1[0].price]
  within 1 min
select e1[0].price as p1, e1[1].price as p2, e2.price as sell
insert into RiseStream;
"""


def md1_send(np, i, B=MD_B, accts=MD_ACCTS):
    """One MD1 send: uniform accounts, log-normal amounts with about 1%
    above 10,000, uniform regions 0-15; one ms of event time a send."""
    rng = np.random.default_rng(1500 + i)
    acct = rng.integers(0, accts, B).astype(np.int64)
    # ln X ~ N(mu, 1.5) with P(X > 10000) = 1%: mu = ln 1e4 - 2.3263 * 1.5
    amount = np.exp(rng.normal(np.log(1e4) - 2.3263 * 1.5, 1.5, B)) \
        .astype(np.float32)
    region = rng.integers(0, 16, B).astype(np.int32)
    ts = np.full(B, 1_000_000 + i, np.int64)
    return [acct, amount, region], ts


def fp1_send(np, i, B=FP_B, devices=FP_DEVICES):
    rng = np.random.default_rng(2500 + i)
    dev_ids = rng.integers(0, devices, B).astype(np.int32)  # interned ids
    reading = rng.uniform(-10.0, 100.0, B).astype(np.float32)
    ok = rng.random(B) < 0.9
    return [dev_ids, reading, ok], np.full(B, 1_000_000 + i, np.int64)


def pm1_send(np, i, B=PM_B):
    rng = np.random.default_rng(3500 + i)
    sym = rng.integers(0, PM_SYMS, B).astype(np.int32)
    price = np.round(rng.uniform(0.0, 100.0, B), 2).astype(np.float32)
    return [sym, price], 1_000_000 + 15_000 * i + np.arange(B,
                                                          dtype=np.int64)


class Capture:
    """Batch callbacks of an app's queries: the valid CURRENT rows of the
    sends whose index is in `check` (as numpy), counts otherwise, and each
    delivery's wall time by its `now`."""

    def __init__(self, rt, queries, check, keep_all=()):
        self.active = True
        self.keep_all = set(keep_all)
        self.rows = {q: {} for q in queries}
        self.count = {q: 0 for q in queries}
        self.delivered = {}
        self.check = set(check)
        self.now_of = {}
        for q in queries:
            rt.add_batch_callback(q, self._cb(q))

    def _cb(self, q):
        def cb(now, payload):
            if not self.active:
                return
            self.count[q] += payload["n_current"]
            self.delivered.setdefault(now, time.perf_counter())
            i = self.now_of.get(now)
            if q in self.keep_all:
                # a downstream reader's `now` is the playback clock when
                # its input arrived: its rows are kept in arrival order
                i = "all"
            if (i in self.check or i == "all") and payload["n_current"]:
                v = payload["valid"] & (payload["kind"] == 0)
                cols = payload["cols"]
                self.rows[q].setdefault(i, []).append(
                    {k: c[v] for k, c in cols.items()})
        return cb

    def get(self, q, i):
        parts = self.rows[q].get(i, [])
        if not parts:
            return {}
        return {k: __import__("numpy").concatenate([p[k] for p in parts])
                for k in parts[0]}


def kernel_counts():
    """Every kernel module's launch and plain-call counters (reset and
    read around a run)."""
    from siddhi_tpu_torch.kernels import (block_nfa, filter_compact,
                                          group_agg, length_window,
                                          multi_filter, pattern_step,
                                          post_filter, ring, time_window)
    return {"filter_compact": filter_compact, "multi_filter": multi_filter,
            "length_window": length_window, "group_agg": group_agg,
            "time_window": time_window, "post_filter": post_filter,
            "pattern_step": pattern_step, "block_nfa": block_nfa,
            "ring": ring}


def reset_all():
    for m in kernel_counts().values():
        m.reset_counts()


def read_all():
    mods = kernel_counts()
    launches = {k: m.launches for k, m in mods.items()}
    launches["pattern_step_stacked"] = mods["pattern_step"].stacked_launches
    launches["ring_pack"] = mods["ring"].pack_launches
    plain = {k: m.plain_calls for k, m in mods.items()}
    plain["pattern_step_stacked"] = \
        mods["pattern_step"].stacked_plain_calls
    return launches, plain


def h2d_profile(torch, run_sends, n):
    """Host-to-device copies of `n` sends under torch.profiler: their count
    and bytes a send (from the trace's memcpy records), the device busy
    time and the idle share of the wall."""
    import json as _json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_sends()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fd, path = tempfile.mkstemp(suffix=".json", dir=".")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = _json.load(fh)
    finally:
        os.remove(path)
    copies = nbytes = 0
    busy_us = 0.0
    for e in trace.get("traceEvents", []):
        cat = str(e.get("cat", "")).lower()
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy_us += float(e.get("dur", 0))
        if cat == "gpu_memcpy" and "HtoD" in str(e.get("name", "")):
            copies += 1
            nbytes += int(e.get("args", {}).get("bytes", 0) or 0)
    if busy_us <= 0:
        return {"h2d_copies": None, "h2d_bytes": None, "device_ms": None,
                "idle_share": None, "wall_ms": wall_ms}
    return {"h2d_copies": copies / n, "h2d_bytes": nbytes / n,
            "device_ms": busy_us / 1e3, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms)}


def drive_app(torch, np, dev, ql, queries, stream, send_fn, n_warm,
              n_timed, check, props=None, n_prof=4, sync_each=False,
              keep_all=(), names=0):
    """Run one app through SiddhiManager on `dev`: `n_warm` warm sends,
    `n_timed` timed sends (per-send producer wall, ev/s over the timed
    sends to the final flush), then `n_prof` profiled sends.  Returns the
    figures, the captured rows and the runtime."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.utils.config import InMemoryConfigManager
    mgr = SiddhiManager(device=dev)
    if props:
        mgr.set_config_manager(InMemoryConfigManager(props))
    # string columns are sent as interner ids: `names` strings interned
    # first take the ids 0 .. names - 1 the senders draw
    for k in range(names):
        mgr.interner.intern(f"id{k}")
    rt = mgr.create_siddhi_app_runtime(ql)
    cap = Capture(rt, queries, check, keep_all)
    rt.start()
    h = rt.get_input_handler(stream)
    sent = {}

    def one(i):
        cols, ts = send_fn(np, i)
        cap.now_of[int(ts.max())] = i
        tb = time.perf_counter()
        sent[int(ts.max())] = tb
        h.send_columns(cols, timestamps=ts)
        return time.perf_counter() - tb
    for i in range(n_warm):
        one(i)
    rt.flush()
    reset_all()
    lat = []
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_timed):
        lat.append(one(i))
        if sync_each:
            rt.flush()
    rt.flush()
    wall = time.perf_counter() - t0
    launches, plain = read_all()
    prof = {"h2d_copies": None, "h2d_bytes": None, "device_ms": None,
            "idle_share": None}
    cap.active = False            # the profiled sends are not checked
    if dev.type == "cuda" and n_prof:
        base = n_warm + n_timed

        def more():
            for i in range(base, base + n_prof):
                one(i)
            rt.flush()
        prof = h2d_profile(torch, more, n_prof)
    lat_ms = np.sort(np.array(lat)) * 1e3
    e2e = [cap.delivered[k] - sent[k] for k in sent if k in cap.delivered]
    fig = {"ev_s": n_timed * len(send_fn(np, 0)[1]) / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "launches": launches, "plain": plain,
           "launches_per_send": sum(v for k, v in launches.items()) /
           n_timed, "e2e_p50_ms": float(np.percentile(e2e, 50)) * 1e3
           if e2e else None, **prof}
    rt.shutdown()
    mgr.shutdown()
    return fig, cap, rt


def md1_model(np, upto, check):
    """MD1's numpy model for the checked sends: the two filters' rows and,
    for each row with amount > 0, its account's sum and count over the
    last 256 such rows (the global length window), its max over every row
    of the account so far (max does not retract in either package: an
    EXPIRED row leaves it as it is), and the rounding bound of the card's
    float32 running sum."""
    accts, amts, regions = [], [], []
    for i in range(upto + 1):
        (a, m, r), _ = md1_send(np, i)
        accts.append(a)
        amts.append(m)
        regions.append(r)
    acct = np.concatenate(accts)
    amt = np.concatenate(amts).astype(np.float64)
    pos = amt > 0
    acct_p, amt_p = acct[pos], amt[pos]
    out = {}
    # each account's row count and largest amount so far (the sum's bound)
    for i in check:
        lo, hi = i * MD_B, (i + 1) * MD_B
        a, m, r = acct[lo:hi], amt[lo:hi], np.concatenate(regions)[lo:hi]
        big = m > 10000.0
        out[("largeTxnAlert", i)] = {"account": a[big], "amount": m[big]}
        sev = r == 7
        out[("regionAudit", i)] = {"account": a[sev], "amount": m[sev],
                                   "region": r[sev]}
        plo = int(pos[:lo].sum())
        phi = plo + int(pos[lo:hi].sum())
        idx = np.arange(plo, phi)
        tot = amt_p[idx].copy()
        n = np.ones(idx.shape[0], np.int64)
        run = np.full(MD_ACCTS, -np.inf)
        np.maximum.at(run, acct_p[:plo], amt_p[:plo])
        peak = np.empty(idx.shape[0])
        for r, (a_, m_) in enumerate(zip(acct_p[idx].tolist(),
                                         amt_p[idx].tolist())):
            run[a_] = max(run[a_], m_)
            peak[r] = run[a_]
        for d in range(1, 256):
            j = idx - d
            ok = j >= 0
            same = np.zeros(idx.shape[0], np.bool_)
            same[ok] = acct_p[j[ok]] == acct_p[idx[ok]]
            if not same.any():
                continue
            tot[same] += amt_p[j[same]]
            n[same] += 1
        k = acct_p[idx]
        seen = np.bincount(acct_p[:phi], minlength=MD_ACCTS)[k]
        mx = np.zeros(MD_ACCTS)
        np.maximum.at(mx, acct_p[:phi], amt_p[:phi])
        out[("spend", i)] = {"account": k, "total": tot, "peak": peak,
                             "n": n, "tol": 2.0 ** -22 * 2 * seen * mx[k]}
    return out


def check_md1(np, cap, model, check, label):
    """The captured rows of the checked sends against the model: exact for
    the filters, count and max, the sum within its rounding bound."""
    for i in check:
        for q in ("largeTxnAlert", "regionAudit"):
            got, want = cap.get(q, i), model[(q, i)]
            for c in want:
                g = got.get(c, np.zeros(0))
                if not np.array_equal(g.astype(np.float64),
                                      want[c].astype(np.float64)):
                    fail(f"{label} {q} send {i}: column {c} differs from "
                         f"numpy ({g.shape[0]} rows, {want[c].shape[0]} "
                         f"expected)")
        sp = model[("spend", i)]
        for q, c in (("spendTotal", "total"), ("spendPeak", "peak"),
                     ("spendCount", "n")):
            got = cap.get(q, i)
            if not np.array_equal(got.get("account"), sp["account"]):
                fail(f"{label} {q} send {i}: accounts differ from numpy")
            g = got[c].astype(np.float64)
            if c == "total":
                err = np.abs(g - sp["total"])
                if np.any(err > sp["tol"]):
                    fail(f"{label} {q} send {i}: sum off by up to "
                         f"{float(err.max())} (bound "
                         f"{float(sp['tol'].max())})")
            elif not np.array_equal(g, sp[c].astype(np.float64)):
                fail(f"{label} {q} send {i}: {c} differs from numpy")


def same_rows(np, a, b, queries, check, label):
    for q in queries:
        for i in (("all",) if q in a.keep_all else check):
            x, y = a.get(q, i), b.get(q, i)
            if x.keys() != y.keys() or any(
                    not np.array_equal(x[k], y[k], equal_nan=True)
                    if x[k].dtype.kind == "f" else
                    not np.array_equal(x[k], y[k]) for k in x):
                fail(f"{label}: {q} send {i} differs")
        if a.count[q] != b.count[q]:
            fail(f"{label}: {q} delivered {a.count[q]} vs {b.count[q]} rows")


def fp1_model(np, i):
    (d, r, ok), _ = fp1_send(np, i)
    keep = ok & (r >= 0.0)
    hot = keep & (r > 90.0)
    return {"fusedClean": (d[keep], r[keep]), "alerts": (d[hot], r[hot])}


def check_fp1(np, cap, check, n_sends, label):
    """fusedClean's rows of the checked sends and alerts' rows over the
    run against numpy."""
    for i in check:
        d, r = fp1_model(np, i)["fusedClean"]
        got = cap.get("fusedClean", i)
        if not (np.array_equal(got.get("deviceId"), d) and
                np.array_equal(got.get("reading"), r)):
            fail(f"{label}: fusedClean send {i} differs from numpy")
    hot = [fp1_model(np, i)["alerts"] for i in range(n_sends)]
    got = cap.get("alerts", "all")
    if not (np.array_equal(got.get("deviceId"),
                           np.concatenate([d for d, _ in hot])) and
            np.array_equal(got.get("reading"),
                           np.concatenate([r for _, r in hot]))):
        fail(f"{label}: alerts differ from numpy")


def print_fig(label, fig, card):
    f = fig
    prof = ("not measured" if f["idle_share"] is None else
            f"idle share {f['idle_share']:.4f} (device busy "
            f"{f['device_ms']:.3f} ms of {f['wall_ms']:.3f} ms wall), "
            f"host-to-device copies a send {f['h2d_copies']:.2f} "
            f"({f['h2d_bytes']:.0f} bytes)")
    e2e = "" if f["e2e_p50_ms"] is None else \
        f", send-to-callback p50 {f['e2e_p50_ms']:.3f} ms"
    print(f"{label}: {f['ev_s']:.0f} ev/s, per-send p50 {f['p50_ms']:.3f} "
          f"ms p99 {f['p99_ms']:.3f} ms{e2e}, launches a send "
          f"{f['launches_per_send']:.2f} {f['launches']}, {prof} [{card}]")


def md1_stage_inputs(torch, np, dev, rt, i):
    """One MD1 send staged on the card as [1, B] and the merge group's
    unit programs (filter spec, gslot, seq counter, keep_expired)."""
    from siddhi_tpu_torch.core import event as ev
    mg = rt.merged_groups["Txn#0"]
    cols, ts = md1_send(np, i)
    n = ts.shape[0]
    staged = ev.StagedBatch(ts, np.zeros(n, np.int32), np.ones(n, np.bool_),
                            cols, n)
    extra = [np.stack([mg.members[idxs[0]]._group_slots(staged)])
             for _, idxs in mg.units]
    batch, g = ev.StackedBatch([staged]).to_device(mg.in_schema, dev, extra)
    progs = []
    for u, (_, idxs) in enumerate(mg.units):
        p = mg.members[idxs[0]].planned
        seq = p.window.arrival_seq(mg._state[u][0])
        progs.append((p.filter_spec, g[u], None if seq is None else
                      seq.clone(), p.window.keeps_expired))
    return batch, progs


def compare_multi(torch, np, k29, specs, batch, gs, seqs, kx, label):
    """K29 against its plain version from the same counters: every row of
    each (program, batch)'s partition and the counts; the counters."""
    s1 = [None if s is None else s.clone() for s in seqs]
    s2 = [None if s is None else s.clone() for s in seqs]
    nows = [0] * batch.ts.shape[0]
    got = k29.multi_filter(specs, batch.ts, batch.kind, batch.valid,
                           batch.cols, gs, nows, s1, kx)
    want = k29.plain(specs, batch.ts, batch.kind, batch.valid, batch.cols,
                     gs, nows, s2, kx)
    err = 0.0
    for p, (rg, rw) in enumerate(zip(got, want)):
        for s, ((r1, n1), (r2, n2)) in enumerate(zip(rg, rw)):
            if int(n1) != int(n2):
                fail(f"{label}: program {p} batch {s} count {int(n1)} vs "
                     f"{int(n2)}")
            for x, y, nm in zip(r1[:5] + tuple(r1.cols),
                                r2[:5] + tuple(r2.cols),
                                ("ts", "kind", "valid", "seq", "gslot") +
                                tuple(f"col{j}" for j in
                                      range(len(r1.cols)))):
                err = max(err, float_err(torch, x, y,
                                         f"{label} p{p} s{s} {nm}"))
    for a, b in zip(s1, s2):
        if a is not None and not torch.equal(a, b):
            fail(f"{label}: seq counters differ")
    return err


def time_multi(torch, np, k29, specs, batch, gs, seqs, kx, label, card):
    S, B = batch.ts.shape
    P = len(specs)
    args = (specs, batch.ts, batch.kind, batch.valid, batch.cols, gs,
            [0] * S, seqs, kx)
    r = {"ms": graph_ms(torch, lambda: k29.launch(*args[:6], *args[7:]),
                        20),
         "plain_ms": event_timer(torch, lambda: k29.plain(*args), 3),
         "library_ms": None}
    counts = [[int(n) for _, n in row] for row in
              k29.launch(*args[:6], *args[7:])]
    kept = sum(sum(c) for c in counts)
    row_in = 8 + 4 + 1 + col_bytes([c[0] for c in batch.cols])
    row_out = 8 + 4 + 1 + 8 + 4 + col_bytes([c[0] for c in batch.cols])
    # the loaded columns and each program's group slots read once, the
    # flags written once, the kept rows written once (the others' invalid
    # tail is written too: counted)
    r.update(bound(S * B * (row_in + 4 * P) + P * S * B * (1 + row_out),
                   P * S * B * max(len(s.bytecode or ()) for s in specs)))
    print(f"kernel multi_filter ({label}: {P} programs x {S} batches of "
          f"{B}, {kept} kept): {r['ms']:.4f} ms (graph replay), plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
          f"{r['bound_by']} ({r['bytes']} bytes); library: none (no one "
          f"PyTorch call filters and compacts P programs over S batches) "
          f"[{card}]")
    return r


def pmc_plan(dev):
    """PMC's query as the runtime plans it under its `@fuse`: a count
    pattern off the block NFA, on the general mode's kernel plan, whose
    stacks `fusion._dispatch_pattern` walks with the stacked mode."""
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
        PMC_QL.format(deco="@fuse(batches='8')"))
    qr = rt.query_runtimes["riseQuery"]
    step = qr.planned.steps["StockStream"]
    if qr.planned.block or step.kernel_plan is None or \
            not step.kernel_plan.general:
        fail("PMC's plan is not the general mode's")
    return qr, step


def pm_stack(torch, np, dev, qr, S, first=0):
    from siddhi_tpu_torch.core import event as ev
    schema = qr.planned.in_schemas["StockStream"]
    staged = []
    nows = []
    for i in range(first, first + S):
        (sym, price), ts = pm1_send(np, i)
        staged.append(ev.StagedBatch(ts, np.zeros(PM_B, np.int32),
                                     np.ones(PM_B, np.bool_), [sym, price],
                                     PM_B))
        nows.append(int(ts.max()))
    sel = np.stack([np.arange(PM_B, dtype=np.int32)[None, :]] * S)
    batch, (sel_t,) = ev.StackedBatch(staged).to_device(schema, dev, [sel])
    key = torch.zeros(1, dtype=torch.int32, device=dev)
    return batch, sel_t, key, nows


def clone_pattern_state(torch, state):
    (b32, b64, sc), ss = state
    return ((b32.clone(), b64.clone(), tuple(x.clone() for x in sc)),
            [x.clone() for x in ss])


def compare_stacked(torch, np, dev, card):
    """The stacked mode on PMC's own plan at PM1's 8 x 1,024 trades (after
    8 warm batches), the plan and stack its phase-60 run launches: against
    8 sequential general-mode launches from one restored state (state,
    headers and rows equal) and, on the stack's first 2 batches, against
    its plain version (2 sequential plain steps: state, counts and
    projected rows equal); its times beside the 8 launches'.  The kernel
    record is the 2-batch stack's, the shape its plain version ran."""
    from siddhi_tpu_torch.kernels import pattern_step as ps
    qr, step = pmc_plan(dev)
    kp = step.kernel_plan
    warm, sel_w, key, nows_w = pm_stack(torch, np, dev, qr, 8, 0)
    pk, ss = qr.state
    pk, ss, _, _ = step.stacked(pk, ss, warm.cols, warm.ts, sel_w, key,
                                nows_w)
    base = clone_pattern_state(torch, (pk, ss))
    batch, sel, key, nows = pm_stack(torch, np, dev, qr, 8, 8)
    st_a = clone_pattern_state(torch, base)
    pk_a, kouts = ps.launch_stacked(kp, st_a[0], batch.cols, batch.ts, sel,
                                    key, nows)
    st_b = clone_pattern_state(torch, base)
    pk_b = st_b[0]
    err = 0.0
    for s in range(8):
        pk_b, kout = ps.launch(kp, pk_b, tuple(c[s] for c in batch.cols),
                               batch.ts[s], None, sel[s], key, nows[s],
                               False)
        a = kouts[s]
        for x, y, nm in ((a[0], kout[0], "header"), (a[1], kout[1], "ts"),
                         (a[2], kout[2], "kind"), (a[3], kout[3], "valid")):
            err = max(err, float_err(torch, x, y, f"stacked s{s} {nm}"))
        for k in a[4]:
            v = a[3]
            err = max(err, float_err(torch, a[4][k][v], kout[4][k][v],
                                     f"stacked s{s} {k}"))
    for x, y, nm in ((pk_a[0], pk_b[0], "b32"), (pk_a[1], pk_b[1], "b64")):
        float_err(torch, x, y, f"stacked state {nm}")
    # against the plain version (S sequential plain steps, about 4 s a
    # batch of 1,024 events on the card) on the stack's first 2 batches
    S2 = 2
    b2 = type(batch)(batch.ts[:S2], batch.kind[:S2], batch.valid[:S2],
                     tuple(c[:S2] for c in batch.cols))
    sel2, nows2 = sel[:S2], nows[:S2]
    st_c = clone_pattern_state(torch, base)
    st_d = clone_pattern_state(torch, base)
    t0 = time.perf_counter()
    pk_c, ss_c, outs_c, _ = step.stacked(st_c[0], st_c[1], b2.cols,
                                         b2.ts, sel2, key, nows2)
    torch.cuda.synchronize()
    kern_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk_d, ss_d = st_d
    outs_d = []
    for s in range(S2):
        pk_d, ss_d, out, _ = step.plain(pk_d, ss_d,
                                        tuple(c[s] for c in batch.cols),
                                        batch.ts[s], sel[s], key, nows[s])
        outs_d.append(out)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for s, (a, b) in enumerate(zip(outs_c, outs_d)):
        if int(a[0]) != int(b[0]) or int(a[1]) != int(b[1]):
            fail(f"stacked vs plain s{s}: counts {int(a[0])}/{int(a[1])} vs "
                 f"{int(b[0])}/{int(b[1])}")
        va, vb = a[4], b[4]
        for x, y, nm in ((a[2][va], b[2][vb], "ts"),) + tuple(
                (x[va], y[vb], f"col{j}")
                for j, (x, y) in enumerate(zip(a[5], b[5]))):
            err = max(err, float_err(torch, x, y, f"stacked vs plain s{s} "
                                                   f"{nm}"))
    for x, y, nm in ((pk_c[0], pk_d[0], "b32"), (pk_c[1], pk_d[1], "b64")):
        float_err(torch, x, y, f"stacked vs plain state {nm}")
    saved = clone_pattern_state(torch, base)[0]

    def restore():
        for x, y in zip(saved[:2], base[0][:2]):
            y.copy_(x)
        for x, y in zip(saved[2], base[0][2]):
            y.copy_(x)
    ms8 = graph_ms(torch, lambda: ps.launch_stacked(
        kp, base[0], batch.cols, batch.ts, sel, key, nows), 10, restore)
    r = {"ms": graph_ms(torch, lambda: ps.launch_stacked(
        kp, base[0], b2.cols, b2.ts, sel2, key, nows2), 10, restore)}

    def eight():
        p = base[0]
        for s in range(8):
            p, _ = ps.launch(kp, p, tuple(c[s] for c in batch.cols),
                             batch.ts[s], None, sel[s], key, nows[s], False)
    seq_ms = graph_ms(torch, eight, 10, restore)
    r["plain_ms"] = plain_ms
    r["library_ms"] = None
    state_bytes = base[0][0].numel() * 4 + base[0][1].numel() * 8
    row = 8 + 4 + 1 + sum(t.element_size() for t in kouts[0][4].values())
    nrows = kouts[0][1].shape[0]
    # the events (sym, price, ts, the selection) read once, the state
    # read and written once, each batch's rows and header written once
    r.update(bound(S2 * PM_B * (4 + 4 + 8 + 4) + 2 * state_bytes +
                   S2 * nrows * row + S2 * 24))
    b8 = bound(8 * PM_B * (4 + 4 + 8 + 4) + 2 * state_bytes +
               8 * nrows * row + 8 * 24)
    print(f"kernel pattern_step stacked mode (PMC's plan, PM1's trades, one "
          f"key): 8 x "
          f"{PM_B} events {ms8:.4f} ms a launch (graph replay; bound "
          f"{b8['bound_ms']:.5f} ms by {b8['bound_by']}, {b8['bytes']} "
          f"bytes) against 8 "
          f"sequential general-mode launches {seq_ms:.4f} ms; 2 x {PM_B} "
          f"events {r['ms']:.4f} ms, plain (2 sequential plain steps) "
          f"{plain_ms:.1f} ms once, the stacked call with projection "
          f"{kern_wall * 1e3:.1f} ms wall; bound (2 x {PM_B}) "
          f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} bytes); "
          f"library: none (no PyTorch call runs an NFA) [{card}]")
    return err, r


def compare_ring(torch, np, dev, rt, card):
    """K30 at MD1's five output blocks (one merged dispatch's outputs):
    `ring_append` against per-leaf index copies into a second ring, then
    `ring_pack` of the slots against the plain pack; their times, the
    library's one `copy_` per leaf."""
    from siddhi_tpu_torch.kernels import ring as k30
    mg = rt.merged_groups["Txn#0"]
    captured = []
    mg._demux = lambda items, results, *_: captured.append(results)
    cols, ts = md1_send(np, 1)
    rt.get_input_handler("Txn").send_columns(cols, timestamps=ts)
    del mg._demux
    outs = [r for r in captured[0][0] if r is not None]
    if len(outs) != 5:
        fail(f"MD1's merged dispatch gave {len(outs)} output blocks")
    blocks = [(h, *o[:3], tuple(o[3])) for o, h in outs]
    err = 0.0
    res = {}
    app_ms, pack_ms, app_plain, pack_plain, lib_ms = [], [], [], [], []
    fetch_ms = []
    nbytes_app = nbytes_pack = 0
    for j, blk in enumerate(blocks):
        ra, rb = k30.alloc(blk, 4), k30.alloc(blk, 4)
        for slot in (1, 2, 3):
            k30.append(ra, blk, slot)
            k30.append_plain(rb, k30.block_leaves(blk), slot)
        for x, y in zip(ra, rb):
            float_err(torch, x, y, f"ring_append block {j}")
        meta_a, rows_a = k30.pack_fetch(ra, 1, 3, k30.PackStaging())
        meta_b, rows_b = k30.pack_plain(rb, 1, 3)
        if not np.array_equal(meta_a, meta_b):
            fail(f"ring_pack block {j}: meta differs")
        for x, y in zip(rows_a, rows_b):
            if x.dtype.kind == "f":
                same = np.array_equal(x, y, equal_nan=True)
            else:
                same = np.array_equal(x, y)
            if not same:
                fail(f"ring_pack block {j}: packed rows differ")
        leaves = k30.block_leaves(blk)
        nb = sum(x.numel() * x.element_size() for x in leaves)
        nbytes_app += 2 * nb
        app_ms.append(graph_ms(torch, lambda: k30.launch_append(
            ra, leaves, 0), 20))
        app_plain.append(event_timer(torch, lambda: k30.append_plain(
            rb, leaves, 0), 5))
        lib_ms.append(event_timer(torch, lambda: [
            d[0].copy_(s) for d, s in zip(rb, leaves)], 5))
        st = k30.PackStaging()
        k30.launch_pack(ra, 1, 3, st)
        pack_ms.append(graph_ms(torch, lambda: k30.pack_kernels(
            ra, 1, 3, st, torch.cuda.current_stream()), 20))
        fetch_ms.append(event_timer(torch, lambda: k30.launch_pack(
            ra, 1, 3, st), 5))
        pack_plain.append(event_timer(torch, lambda: k30.pack_plain(
            rb, 1, 3), 3))
        valid = int(meta_a[:, -1].sum())
        row = sum(t.element_size() for t in ra[2:])
        nbytes_pack += 3 * blk[3].numel() + 2 * valid * row + \
            meta_a.size * 8 * 2
    res["ring_append"] = {"ms": sum(app_ms), "plain_ms": sum(app_plain),
                          "library_ms": sum(lib_ms)}
    res["ring_append"].update(bound(nbytes_app))
    res["ring_pack"] = {"ms": sum(pack_ms), "plain_ms": sum(pack_plain),
                        "library_ms": None}
    res["ring_pack"].update(bound(nbytes_pack))
    for k, r in res.items():
        lib = (f"{r['library_ms']:.4f} ms (one copy_ per leaf)"
               if r["library_ms"] is not None else
               "none (no one PyTorch call packs the valid rows of m slots)")
        print(f"kernel {k} (MD1's five output blocks, each once, 3 slots a "
              f"pack; graph replay): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']} ({r['bytes']} bytes), library {lib} [{card}]")
    print(f"ring_pack with its two device-to-host transfers and the host's "
          f"unpack (CUDA events): {sum(fetch_ms):.4f} ms over the five "
          f"blocks [{card}]")
    return err, res


def slice15_phases(torch, np, dev):
    """Phases 57-62 (the dispatch layer): K29, the stacked mode and K30
    against their plain versions at full size, then MD1 merged and
    unmerged, FP1 fused and unfused, PM1 and PMC fused, SV1, and FP1 under
    @pipeline(depth='4') and @async.  Returns the kernel records."""
    from siddhi_tpu_torch.kernels import multi_filter as k29
    t0 = time.perf_counter()
    card = card_line()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 15 {what}: {time.perf_counter() - t0:.1f} s")
    # -- phase 57: the kernels against their plain versions ----------------
    from siddhi_tpu_torch import SiddhiManager
    md_rt = SiddhiManager(device=dev).create_siddhi_app_runtime(md1_ql())
    batch, progs = md1_stage_inputs(torch, np, dev, md_rt, 0)
    specs = [p[0] for p in progs]
    gs = [p[1] for p in progs]
    kx = [p[3] for p in progs]
    err = compare_multi(torch, np, k29, specs, batch, gs,
                        [p[2] for p in progs], kx, "K29 MD1 merged stage")
    k29_md = time_multi(torch, np, k29, specs, batch, gs,
                        [p[2] for p in progs], kx, "MD1's merged stage",
                        card)
    fp_rt = SiddhiManager(device=dev).create_siddhi_app_runtime(fp1_ql())
    fq = fp_rt.query_runtimes["fusedClean"]
    from siddhi_tpu_torch.core import event as ev
    staged = []
    for i in range(8):
        cols, ts = fp1_send(np, i)
        staged.append(ev.StagedBatch(ts, np.zeros(FP_B, np.int32),
                                     np.ones(FP_B, np.bool_), cols, FP_B))
    fbatch, (fg,) = ev.StackedBatch(staged).to_device(
        fq.planned.in_schema, dev, [np.zeros((8, FP_B), np.int32)])
    fseq = fq.planned.window.arrival_seq(fq.state[0])
    fargs = ([fq.planned.filter_spec], fbatch, [fg],
             [None if fseq is None else fseq.clone()], [False])
    err = max(err, compare_multi(torch, np, k29, fargs[0], fargs[1],
                                 fargs[2], fargs[3], fargs[4],
                                 "K29 FP1 fused stage"))
    time_multi(torch, np, k29, *fargs, "FP1's fused stage", card)
    del fbatch, fg, staged
    took("phase 57 K29 done")
    s_err, stacked = compare_stacked(torch, np, dev, card)
    took("phase 57 stacked mode done")
    # -- phase 58: MD1 merged and unmerged ---------------------------------
    check = MD_CHECK
    merged, cap_m, rt_m = drive_app(torch, np, dev, md1_ql(), MD_QUERIES,
                                    "Txn", md1_send, MD_WARM, MD_SENDS,
                                    check)
    if not rt_m.merged_groups:
        fail("MD1 ran unmerged")
    unmerged, cap_u, _ = drive_app(
        torch, np, dev, md1_ql(), MD_QUERIES, "Txn", md1_send, MD_WARM,
        MD_SENDS, check, props={"optimizer.merge.enabled": "false"})
    check_launched("MD1 merged", merged["launches"], merged["plain"],
                   ("multi_filter", "length_window", "group_agg"))
    if merged["launches"]["filter_compact"] != \
            MD_SENDS:      # slowBurn alone keeps K1
        fail(f"MD1 merged: filter_compact launched "
             f"{merged['launches']['filter_compact']} times (slowBurn's "
             f"{MD_SENDS} expected)")
    check_launched("MD1 unmerged", unmerged["launches"], unmerged["plain"],
                   ("filter_compact", "length_window", "group_agg"))
    same_rows(np, cap_m, cap_u, MD_QUERIES[:5], check, "MD1 merged vs "
              "unmerged")
    model = md1_model(np, max(check), check)
    check_md1(np, cap_m, model, check, "MD1 merged")
    print_fig("MD1 merged", merged, card)
    print_fig("MD1 unmerged", unmerged, card)
    launches = {"multi_filter": merged["launches"]["multi_filter"]}
    took("phase 58 MD1 done")
    # -- phase 59: FP1 fused and unfused -----------------------------------
    fcheck = (0, FP_SENDS - 1)
    fused, cap_f, _ = drive_app(torch, np, dev, fp1_ql(), FP_QUERIES,
                                "SensorStream", fp1_send, 0, FP_SENDS,
                                fcheck, n_prof=8, keep_all=("alerts",),
                                names=FP_DEVICES)
    unfused, cap_g, _ = drive_app(torch, np, dev, fp1_ql(""), FP_QUERIES,
                                  "SensorStream", fp1_send, 0, FP_SENDS,
                                  fcheck, n_prof=8, keep_all=("alerts",),
                                  names=FP_DEVICES)
    check_launched("FP1 fused", fused["launches"], fused["plain"],
                   ("multi_filter", "filter_compact"))
    same_rows(np, cap_f, cap_g, FP_QUERIES, fcheck, "FP1 fused vs unfused")
    check_fp1(np, cap_f, fcheck, FP_SENDS, "FP1 fused")
    print_fig("FP1 fused (@fuse(batches='8'); send-to-callback includes the "
              "wait in the stack)", fused, card)
    print_fig("FP1 unfused", unfused, card)
    launches["multi_filter"] += fused["launches"]["multi_filter"]
    took("phase 59 FP1 done")
    # -- phase 60: PM1 and PMC fused ---------------------------------------
    pcheck = tuple(range(PM_SENDS))
    pf, cap_pf, _ = drive_app(torch, np, dev, pm1_ql(), ("riseQuery",),
                              "StockStream", pm1_send, 0, PM_SENDS, pcheck,
                              n_prof=0, names=PM_SYMS)
    pu, cap_pu, _ = drive_app(torch, np, dev, pm1_ql(""), ("riseQuery",),
                              "StockStream", pm1_send, 0, PM_SENDS, pcheck,
                              n_prof=0, names=PM_SYMS)
    same_rows(np, cap_pf, cap_pu, ("riseQuery",), pcheck,
              "PM1 fused vs unfused")
    check_launched("PM1 fused", pf["launches"], pf["plain"], ("block_nfa",))
    print_fig("PM1 fused (a simple chain: block NFA batch after batch)", pf,
              card)
    cf, cap_cf, _ = drive_app(torch, np, dev, PMC_QL.format(
        deco="@fuse(batches='8')"), ("riseQuery",), "StockStream", pm1_send,
        0, PM_SENDS, pcheck, n_prof=0, names=PM_SYMS)
    cu, cap_cu, _ = drive_app(torch, np, dev, PMC_QL.format(deco=""),
                              ("riseQuery",), "StockStream", pm1_send, 0,
                              PM_SENDS, pcheck, n_prof=0, names=PM_SYMS)
    same_rows(np, cap_cf, cap_cu, ("riseQuery",), pcheck,
              "PMC fused vs unfused")
    check_launched("PMC fused", cf["launches"], cf["plain"],
                   ("pattern_step_stacked",))
    if cap_cf.count["riseQuery"] == 0:
        fail("PMC delivered no match")
    print_fig("PMC fused (count pattern: the stacked mode)", cf, card)
    print_fig("PMC unfused", cu, card)
    launches["pattern_step_stacked"] = \
        cf["launches"]["pattern_step_stacked"]
    took("phase 60 PM1 / PMC done")
    # -- phase 61: SV1 (MD1 served) ----------------------------------------
    from siddhi_tpu_torch.kernels import ring as k30
    sv, cap_s, rt_s = drive_app(torch, np, dev, md1_ql("@app:serve\n"),
                                MD_QUERIES, "Txn", md1_send, MD_WARM,
                                MD_SENDS, check)
    check_launched("SV1", sv["launches"], sv["plain"],
                   ("multi_filter", "ring", "ring_pack"))
    same_rows(np, cap_s, cap_m, MD_QUERIES[:5], check, "SV1 vs MD1")
    sd = rt_s._serve_drainer
    rings = [m.__dict__.get("_serve_ring")
             for m in rt_s.query_runtimes.values()]
    used = max(r.max_occupancy for r in rings if r is not None)
    print_fig("SV1 (MD1 under @app:serve; per-send wall is the producer's, "
              "which does not wait on the card)", sv, card)
    print(f"SV1: ring slots used at most {used}, drain rounds "
          f"{sd.drains_total}, device-to-host transfers {k30.d2h_transfers} "
          f"(the counters since the last reset, the profiled sends "
          f"included) [{card}]")
    launches["ring_append"] = sv["launches"]["ring"]
    launches["ring_pack"] = sv["launches"]["ring_pack"]
    took("phase 61 SV1 done")
    r_err, ring_res = compare_ring(torch, np, dev, md_rt, card)
    err = max(err, r_err)
    took("phase 57 K30 done")
    # -- phase 62: FP1 under @pipeline(depth='4') and @async ---------------
    for deco in ("@pipeline(depth='4')", "@async"):
        fig, cap_x, _ = drive_app(
            torch, np, dev, fp1_ql(f"@fuse(batches='8') {deco}"),
            FP_QUERIES, "SensorStream", fp1_send, 0, FP_SENDS, fcheck,
            n_prof=0, keep_all=("alerts",), names=FP_DEVICES)
        same_rows(np, cap_x, cap_g, FP_QUERIES, fcheck, f"FP1 {deco}")
        print_fig(f"FP1 {deco}", fig, card)
    took("phase 62 done")
    rec = []
    for name, src, rep, r in (
            ("multi_filter", "multi_filter", "siddhi_tpu/optimizer/mqo.py:199",
             k29_md),
            ("pattern_step_stacked", "pattern_step",
             "siddhi_tpu/core/fusion.py:247", stacked),
            ("ring_append", "ring", "siddhi_tpu/serving/ring.py:104",
             ring_res["ring_append"]),
            ("ring_pack", "ring", "siddhi_tpu/serving/ring.py:109",
             ring_res["ring_pack"])):
        rec.append({"name": name, "route": "cuda",
                    "source": f"siddhi_tpu_torch/csrc/{src}.cu",
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": max(err, s_err), "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return rec



# ---------------------------------------------------------------------------
# slice 16: sharding over the key axis (A14) on N logical shards of the one
# card - kernels K31 shard_route and K32 shard_merge
# ---------------------------------------------------------------------------

S16_N = 4                 # logical shards: ShardMesh([cuda:0] * 4)
S16_P1_SENDS = 8          # P1 sends a run (unsharded, then on the mesh)
S16_PG1_SENDS = 40        # PG1 sends a run: past its 30 s idle period
S16_R = 2 * P1_B          # P1's output rows a send (CURRENT + EXPIRED)

# a copy of the JAX package's `MC_FLAGSHIP_QL`
# (siddhi_tpu/analysis/corpus.py:52): the flagship with @fuse(batches='4')
MC_FLAGSHIP_QL = """
@app:playback
define stream TradeStream (key long, price float, volume int);
partition with (key of TradeStream)
begin
  @capacity(keys='{keys}', slots='4')
  @emit(rows='2')
  @fuse(batches='4')
  @info(name='flagship')
  from every e1=TradeStream[volume == 1]
       -> e2=TradeStream[volume == 2 and price >= e1.price]
       -> e3=TradeStream[volume == 3]
       -> e4=TradeStream[volume == 4 and price >= e3.price]
  select e1.key as k, e1.price as p1, e2.price as p2, e4.price as p4
  insert into Matches;
end;
"""


def slice16_modules():
    from siddhi_tpu_torch.kernels import (filter_compact, group_agg,
                                          keyed_window, pattern_step,
                                          shard_merge, shard_route)
    return {"pattern_step": pattern_step, "keyed_window": keyed_window,
            "group_agg": group_agg, "filter_compact": filter_compact,
            "shard_route": shard_route, "shard_merge": shard_merge}


def s16_mesh(dev):
    from siddhi_tpu_torch.sharding import ShardMesh
    return ShardMesh([dev] * S16_N)


def s16_same(torch, a, b, what):
    """Exact equality of two tensors (floats by their bits)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    if a.shape != b.shape or not torch.equal(a, b):
        fail(f"{what}: kernel != plain version")


def s16_time(torch, res, name, fn, plain, library, nbytes, reps=50):
    r = {"ms": graph_ms(torch, fn, reps),
         "plain_ms": event_timer(torch, plain, max(5, reps // 5)),
         "library_ms": None if library is None else
         event_timer(torch, library, reps)}
    r.update(bound(nbytes))
    res[name] = r
    return r


def s16_kernels(torch, np, dev, card):
    """Phase 63: K31's three modes and K32's three modes against their
    plain versions on the card at the main path's shapes, n = 4, and their
    CUDA-graph times beside their bounds and the one-call PyTorch time
    where there is one.  Returns (max_abs_err, {mode: timing})."""
    from siddhi_tpu_torch.kernels import shard_merge as k32, \
        shard_route as k31
    n = S16_N
    rng = np.random.default_rng(160)
    res = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # K31 plain: a send of 131,072 rows over PG1's 2^21 group slots
    g = t(rng.integers(-1, PG1_KEYS_CAP, P1_B).astype(np.int32))
    v = t(rng.random(P1_B) > 0.1)
    for a, b in zip(k31.route_plain(g, v, n), k31.plain_route_plain(g, v, n)):
        s16_same(torch, a, b, "K31 plain mode")
    s16_time(torch, res, f"route plain ({P1_B} rows)",
             lambda: k31.route_plain(g, v, n),
             lambda: k31.plain_route_plain(g, v, n), None,
             P1_B * (4 + 1) + n * P1_B * (1 + 4))
    # K31 keyed: the flagship's 2^17 key rows of 2^20 keys (padding too)
    key = np.full(BATCH, N_KEYS, np.int32)
    live = BATCH - BATCH // 128
    key[:live] = rng.permutation(N_KEYS)[:live]
    key = t(key)
    s16_same(torch, k31.route_keyed(key, n, N_KEYS),
             k31.plain_route_keyed(key, n, N_KEYS), "K31 keyed mode")
    s16_time(torch, res, f"route keyed ({BATCH} key rows)",
             lambda: k31.route_keyed(key, n, N_KEYS),
             lambda: k31.plain_route_keyed(key, n, N_KEYS), None,
             BATCH * 4 + n * BATCH * 4)
    # K31 place: P1's per-key-row output counts (about two rows a key row)
    owner = rng.integers(0, n, BATCH)
    cnt = np.zeros((n, BATCH), np.int64)
    cnt[owner, np.arange(BATCH)] = rng.integers(1, 4, BATCH)
    total = int(cnt.sum())
    cnt = t(cnt)
    s16_same(torch, k31.place(cnt, total), k31.plain_place(cnt, total),
             "K31 place mode")
    s16_time(torch, res, f"route place ({total} rows)",
             lambda: k31.place(cnt, total),
             lambda: k31.plain_place(cnt, total), None,
             n * BATCH * 8 + total * 8, reps=10)
    # K32 rows: P1's row-aligned outputs on 4 shards, each row owned by
    # one shard, -0.0 / NaN / +-inf planted in an f32 and an f64 column
    R = S16_R
    own = rng.integers(-1, n, R)
    valid = [t(own == d) for d in range(n)]
    special = np.array([-0.0, np.nan, np.inf, -np.inf])
    cols = []
    for d in range(n):
        f32 = rng.standard_normal(R).astype(np.float32)
        f64 = rng.standard_normal(R)
        f32[:4], f64[:4] = special, special
        cols.append((t(rng.integers(0, 1 << 40, R)),           # ts
                     t(rng.integers(0, 2, R).astype(np.int32)),  # kind
                     t((rng.integers(0, 97, R)).astype(np.int32)),
                     t(rng.integers(0, P1_KEYS, R)),
                     t(f64), t(f32)))
    ka = k32.merge_rows(cols, valid, R)
    kb = k32.plain_merge_rows(cols, valid, R)
    for a, b in zip(ka[0] + (ka[1],), kb[0] + (kb[1],)):
        s16_same(torch, a, b, "K32 rows mode")
    if bool(torch.signbit(ka[0][4][0])):
        fail("K32 rows mode kept an owned -0.0")
    stacked = [torch.stack([c[j] for c in cols]) for j in range(6)]
    vs = torch.stack(valid)

    def lib_rows():
        for x in stacked:
            torch.where(vs, x, torch.zeros((), dtype=x.dtype,
                                           device=dev)).sum(0)
    row_bytes = sum(x.element_size() for x in cols[0]) + 1
    s16_time(torch, res, f"merge rows ({R} rows x 6 columns)",
             lambda: k32.merge_rows(cols, valid, R),
             lambda: k32.plain_merge_rows(cols, valid, R), lib_rows,
             n * R * row_bytes + R * row_bytes)
    # K32 placed rows: the same rows compacted per shard
    pcols, pval, ppos = [], [], []
    for d in range(n):
        idx = torch.nonzero(valid[d]).flatten()
        pcols.append(tuple(c[idx] for c in cols[d]))
        pval.append(torch.ones(idx.shape[0], dtype=torch.bool, device=dev))
        ppos.append(idx)
    pa = k32.merge_rows(pcols, pval, R, pos=ppos)
    pb = k32.plain_merge_rows(pcols, pval, R, pos=ppos)
    for a, b in zip(pa[0] + (pa[1],), pb[0] + (pb[1],)):
        s16_same(torch, a, b, "K32 placed rows")
    for a, b in zip(pa[0], ka[0]):
        s16_same(torch, a, b, "K32 placed rows against aligned rows")
    m = sum(x.shape[0] for x in pval)
    s16_time(torch, res, f"merge placed rows ({m} rows x 6 columns)",
             lambda: k32.merge_rows(pcols, pval, R, pos=ppos),
             lambda: k32.plain_merge_rows(pcols, pval, R, pos=ppos), None,
             m * (row_bytes + 8) + R * row_bytes)
    # K32 delta: P1's replicated selector state, one changer an element
    from siddhi_tpu_torch import SiddhiManager
    prt = SiddhiManager(device=dev).create_siddhi_app_runtime(P1_QL)
    leaves = prt.query_runtimes["p1"].state[1]
    del prt
    err = 0.0
    dbytes = 0
    pairs = []
    for leaf in leaves:
        old = leaf.clone()
        if old.dtype.is_floating_point:
            old.copy_(t(rng.standard_normal(old.numel())).to(old.dtype))
            old[:3] = torch.tensor([np.inf, np.nan, -0.0], dtype=old.dtype)
        changer = t(rng.integers(-1, n, old.numel()))
        news = []
        for d in range(n):
            x = old.clone()
            fresh = t(rng.integers(0, 100, old.numel())).to(old.dtype)
            news.append(torch.where(changer == d, fresh, x))
        if old.dtype.is_floating_point:
            news[n - 1][0] = 5.0
        a = k32.merge_delta(old, news)
        b = k32.plain_merge_delta(old, news)
        s16_same(torch, a, b, "K32 delta mode")
        if old.dtype.is_floating_point and not bool(torch.isnan(a[0])):
            fail("K32 delta mode: +inf -> 5 did not give NaN")
        a = k32.merge_delta(old, news, finite_old=True)
        b = k32.plain_merge_delta(old, news, finite_old=True)
        s16_same(torch, a, b, "K32 delta mode (finite_old)")
        pairs.append((old, news))
        dbytes += (n + 2) * old.numel() * old.element_size()

    def run_delta(fn):
        for old, news in pairs:
            fn(old, news, finite_old=True)

    def lib_delta():
        for old, news in pairs:
            st = torch.stack(news)
            old + torch.where(st != old, st - old,
                              torch.zeros((), dtype=st.dtype,
                                          device=dev)).sum(0)
    s16_time(torch, res, f"merge delta ({len(pairs)} leaves x "
             f"{leaves[0].numel()} slots)",
             lambda: run_delta(k32.merge_delta),
             lambda: run_delta(k32.plain_merge_delta), lib_delta, dbytes)
    # K32 header: the flagship's four shard headers [n_valid, n_dropped,
    # wake]
    hdrs = [t(np.array([int(rng.integers(0, BATCH)), 0,
                        int(rng.integers(1, 1 << 40))], np.int64))
            for _ in range(n)]
    s16_same(torch, k32.merge_header(hdrs, (2,)),
             k32.plain_merge_header(hdrs, (2,)), "K32 header mode")
    hs = torch.stack(hdrs)

    def lib_hdr():
        hs[:, :2].sum(0)
        torch.amin(hs[:, 2])
    s16_time(torch, res, "merge header (4 shards x 3 words)",
             lambda: k32.merge_header(hdrs, (2,)),
             lambda: k32.plain_merge_header(hdrs, (2,)), lib_hdr,
             (n + 1) * 3 * 8)
    for k, r in res.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"kernel K3{1 if k.startswith('route') else 2} {k} (n = {n}; "
              f"graph replay): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
              f"({r['bytes']} bytes), one-call PyTorch {lib} [{card}]")
    return err, res


def s16_flagship(torch, np, dev, ql, mesh, mods, label):
    """One sweep of the flagship's sends (8 blocks of 2^17 keys x 4
    events over 2^20 keys) through SiddhiManager, unsharded or on `mesh`.
    Returns (match rows sorted, each send's delivered keys in row order,
    ev/s, launches, plain calls, the runtime)."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(ql, mesh=mesh) if mesh is not None \
        else mgr.create_siddhi_app_runtime(ql)
    got = []

    def on_batch(ts, b):
        v = b["valid"]
        c = b["cols"]
        got.append(np.stack([c["k"][v].astype(np.float64), c["p1"][v],
                             c["p2"][v], c["p4"][v]], 1))
    rt.add_batch_callback("flagship", on_batch)
    rt.start()
    h = rt.get_input_handler("TradeStream")
    blocks = N_KEYS // BATCH
    vol4 = np.tile(np.array([1, 2, 3, 4], np.int32), BATCH)
    price4 = vol4.astype(np.float32)
    sends = []
    for b in range(blocks):
        keys = np.repeat(np.arange(b * BATCH, (b + 1) * BATCH,
                                   dtype=np.int64), 4)
        ts = 1000 + 10 * b + np.tile(np.arange(4, dtype=np.int64), BATCH)
        sends.append(([keys, price4, vol4], ts))
    h.send_columns(sends[0][0], timestamps=sends[0][1])     # warm
    rt.flush()
    got.clear()
    for mo in mods.values():
        mo.reset_counts()
    t0 = time.perf_counter()
    for cols, ts in sends[1:]:
        h.send_columns(cols, timestamps=ts)
    rt.flush()
    dt = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    rows = np.concatenate(got) if got else np.zeros((0, 4))
    order = [g[:, 0].astype(np.int64) for g in got]
    evs = (blocks - 1) * BATCH * 4 / dt
    mgr.shutdown()
    return rows[np.lexsort(rows.T[::-1])], order, evs, launches, plain, rt


def s16_rows_run(torch, np, dev, ql, qname, stream, sends, mesh, mods):
    """Every send's delivered rows (ts, kind, the columns; valid rows in
    row order) of `qname`, unsharded or on `mesh`, with the kernels'
    launches and plain calls and the wall seconds."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(ql, mesh=mesh) if mesh is not None \
        else mgr.create_siddhi_app_runtime(ql)
    got = []

    def on_batch(ts, b):
        v = b["valid"]
        got.append([b["ts"][v], b["kind"][v]] +
                   [c[v] for c in b["cols"].values()])
    rt.add_batch_callback(qname, on_batch)
    rt.start()
    h = rt.get_input_handler(stream)
    for mo in mods.values():
        mo.reset_counts()
    t0 = time.perf_counter()
    for cols, ts in sends:
        h.send_columns(cols, timestamps=ts)
    rt.flush()
    dt = time.perf_counter() - t0
    launches = {k: mo.launches for k, mo in mods.items()}
    plain = {k: mo.plain_calls for k, mo in mods.items()}
    alloc = rt.query_runtimes[qname].planned.slot_allocator
    used = None if alloc is None else np.array(alloc._used, copy=True)
    mgr.shutdown()
    return got, launches, plain, dt, used


def s16_same_rows(np, a, b, what):
    if len(a) != len(b):
        fail(f"{what}: {len(a)} batches against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, w) in enumerate(zip(x, y)):
            if u.shape != w.shape or u.tobytes() != w.tobytes():
                fail(f"{what}: batch {i} column {j} differs")


def slice16_phases(torch, np, dev):
    """Phases 63-67 (sharding over the key axis on 4 logical shards of the
    card): K31 / K32 against their plain versions (63), the flagship at
    2^20 keys unsharded and on the mesh (64), its @fuse variant on the
    mesh (65), P1 (66) and PG1 (67) unsharded and on the mesh.  Returns
    the kernel records."""
    t0 = time.perf_counter()
    card = card_line()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 16 {what}: {time.perf_counter() - t0:.1f} s")
    err, res = s16_kernels(torch, np, dev, card)
    took("phase 63 done")
    mods = slice16_modules()
    mesh = s16_mesh(dev)
    main = {"shard_route": 0, "shard_merge": 0}
    # -- phase 64: the flagship, unsharded and on the mesh -----------------
    ql = FLAGSHIP_QL.format(n_keys=N_KEYS)
    base, _, ev_u, l_u, p_u, _ = s16_flagship(torch, np, dev, ql, None,
                                              mods, "unsharded")
    rows, order, ev_m, l_m, p_m, rt = s16_flagship(torch, np, dev, ql, mesh,
                                                   mods, "mesh")
    sends = N_KEYS // BATCH - 1
    if base.shape[0] != sends * BATCH:
        fail(f"S16 flagship: {base.shape[0]} unsharded matches")
    if rows.shape != base.shape or rows.tobytes() != base.tobytes():
        fail("S16 flagship: the mesh's matches differ from the unsharded")
    check_launched("S16 flagship on the mesh", l_m, p_m,
                   ("pattern_step", "shard_merge"))
    qr = rt.query_runtimes["flagship"]
    alloc = qr.slot_allocator
    kb = None
    for keys in order:
        shard = alloc.slots_for([keys], np.ones(keys.shape[0], bool)) % \
            S16_N
        if np.any(np.diff(shard) < 0):
            fail("S16 flagship: the mesh's rows are not shard-major")
        kb = np.bincount(shard, minlength=S16_N)
    main["shard_merge"] += l_m["shard_merge"]
    print(f"S16 flagship (2^20 keys, {sends} sends of {BATCH} keys x 4): "
          f"unsharded {ev_u:.0f} ev/s, pattern_step launches "
          f"{l_u['pattern_step'] / sends:.2f} a send; on {S16_N} logical "
          f"shards {ev_m:.0f} ev/s, pattern_step launches "
          f"{l_m['pattern_step'] / sends:.2f} and K32 launches "
          f"{l_m['shard_merge'] / sends:.2f} a send; each shard's Kb "
          f"{kb.tolist()} key rows; matches equal, rows shard-major "
          f"[{card}]")
    took("phase 64 done")
    # -- phase 65: the @fuse variant on the mesh ----------------------------
    mrows, _, ev_f, l_f, p_f, frt = s16_flagship(
        torch, np, dev, MC_FLAGSHIP_QL.format(keys=N_KEYS), mesh, mods,
        "fused mesh")
    if frt.query_runtimes["flagship"]._fuse is None:
        fail("S16 MC flagship: @fuse did not apply on the mesh")
    if mrows.shape != base.shape or mrows.tobytes() != base.tobytes():
        fail("S16 MC flagship: the fused mesh's matches differ")
    check_launched("S16 MC flagship (fused, on the mesh)", l_f, p_f,
                   ("pattern_step", "shard_merge"))
    main["shard_merge"] += l_f["shard_merge"]
    print(f"S16 MC flagship (@fuse(batches='4') on {S16_N} logical "
          f"shards): {ev_f:.0f} ev/s, pattern_step launches "
          f"{l_f['pattern_step'] / sends:.2f} a send; matches equal "
          f"[{card}]")
    took("phase 65 done")
    # -- phase 66: P1 ------------------------------------------------------
    rng = np.random.default_rng(166)
    p1s = [p1_send(np, rng, i) for i in range(S16_P1_SENDS)]
    gu, lu, pu, du, _ = s16_rows_run(torch, np, dev, P1_QL, "p1",
                                     "TempStream", p1s, None, mods)
    gm, lm, pm, dm, _ = s16_rows_run(torch, np, dev, P1_QL, "p1",
                                     "TempStream", p1s, mesh, mods)
    s16_same_rows(np, gm, gu, "S16 P1 mesh vs unsharded")
    check_launched("S16 P1 on the mesh", lm, pm,
                   ("keyed_window", "group_agg", "shard_route",
                    "shard_merge"))
    for k in main:
        main[k] += lm[k]
    n_ev = S16_P1_SENDS * P1_B
    print(f"S16 P1 (keyed length(10), 2^20 keys, {S16_P1_SENDS} sends): "
          f"unsharded {n_ev / du:.0f} ev/s, on {S16_N} logical shards "
          f"{n_ev / dm:.0f} ev/s (each shard runs the whole [Kb, E] "
          f"grouping); rows equal in order; keyed_window launches "
          f"{lu['keyed_window']} / {lm['keyed_window']} [{card}]")
    took("phase 66 done")
    # -- phase 67: PG1 -----------------------------------------------------
    rng = np.random.default_rng(167)
    pgs = [pg1_send(np, rng, i) for i in range(S16_PG1_SENDS)]
    gu, lu, pu, du, used_u = s16_rows_run(torch, np, dev, PG1_QL, "pg1",
                                          "TempStream", pgs, None, mods)
    gm, lm, pm, dm, used_m = s16_rows_run(torch, np, dev, PG1_QL, "pg1",
                                          "TempStream", pgs, mesh, mods)
    s16_same_rows(np, gm, gu, "S16 PG1 mesh vs unsharded")
    if not np.array_equal(used_u, used_m):
        fail("S16 PG1: the purger freed other keys on the mesh")
    drawn = np.unique(np.concatenate([c[0] for c, _ in pgs])).shape[0]
    if int(used_m.sum()) >= drawn:
        fail("S16 PG1: the purger freed no key")
    check_launched("S16 PG1 on the mesh", lm, pm,
                   ("filter_compact", "group_agg", "shard_route",
                    "shard_merge"))
    for k in main:
        main[k] += lm[k]
    n_ev = S16_PG1_SENDS * PG1_B
    print(f"S16 PG1 (no window, @purge, 2^21 group slots, "
          f"{S16_PG1_SENDS} sends): unsharded {n_ev / du:.0f} ev/s, on "
          f"{S16_N} logical shards {n_ev / dm:.0f} ev/s; rows equal in "
          f"order; the allocator holds {int(used_m.sum())} keys of the "
          f"{drawn} sent, the same slots on both [{card}]")
    took("phase 67 done")
    rec = []
    for name, rep, modes in (
            ("shard_route", "siddhi_tpu/core/planner.py:193",
             [k for k in res if k.startswith("route")]),
            ("shard_merge", "siddhi_tpu/core/planner.py:141",
             [k for k in res if k.startswith("merge")])):
        ms = sum(res[k]["ms"] for k in modes)
        libs = [res[k]["library_ms"] for k in modes]
        b = bound(sum(res[k]["bytes"] for k in modes))
        rec.append({"name": name, "route": "cuda",
                    "source": f"siddhi_tpu_torch/csrc/{name}.cu",
                    "replaces": rep, "launches": main[name],
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": sum(res[k]["plain_ms"] for k in modes),
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "library_ms": None if any(x is None for x in libs)
                    else sum(libs)})
    return rec



# ---------------------------------------------------------------------------
# slice 17: statistics and the state observatory (@app:statistics); the
# window-fill probe K33 fill_probe
# ---------------------------------------------------------------------------

S17_TIMED = 16            # timed config 1 sends an arm (after FILL)
S17_PROF = 4              # profiled sends an arm (device-to-host copies)
S17_ON = {"state.obs.sample.every": "1"}
S17_OFF = {"state.obs.enabled": "false"}


def s17_manager(dev, conf):
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.utils.config import InMemoryConfigManager
    mgr = SiddhiManager(device=dev)
    mgr.set_config_manager(InMemoryConfigManager(dict(conf)))
    return mgr


def s17_copies(torch, run_sends, n):
    """Device-to-host and host-to-device copies a send of `n` sends under
    torch.profiler (the trace's memcpy records, as `h2d_profile` reads
    them)."""
    import json as _json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_sends()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=".")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = _json.load(fh)
    finally:
        os.remove(path)
    d2h = h2d = device = 0
    for e in trace.get("traceEvents", []):
        cat = str(e.get("cat", "")).lower()
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device += 1
        if cat == "gpu_memcpy":
            name = str(e.get("name", ""))
            d2h += "DtoH" in name
            h2d += "HtoD" in name
    return {"d2h": d2h / max(n, 1), "h2d": h2d / max(n, 1),
            "device_events": device}


def s17_config1_arm(torch, np, dev, stats, obs, card):
    """Phase 69, one arm: config 1 at full width (131,072 events a send,
    its 2^24-row window filled by 100 sends, then S17_TIMED timed sends)
    with `@app:statistics('BASIC')` or not (`stats`), and the observatory
    with the probe on every dispatch or off (`obs`); then S17_PROF
    profiled sends for the copies a send.  Returns (mgr, rt, launches,
    plain, ev/s, copies)."""
    from siddhi_tpu_torch.kernels import fill_probe
    mods = dict(single_modules(), fill_probe=fill_probe)
    mgr = s17_manager(dev, S17_ON if obs else S17_OFF)
    rt = mgr.create_siddhi_app_runtime(
        ("@app:statistics('BASIC')\n" if stats else "") + CONFIG1_QL)
    rng = np.random.default_rng(2)
    sends = [(config_rows(np, rng), np.full(B1, 1000 + 10 * i, np.int64))
             for i in range(FILL + S17_TIMED)]
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "q", "S", sends, FILL, mods, timed=S17_TIMED)
    if any(c != (B1, B1) for c in counts[FILL:]):
        fail(f"S17 config 1: steady (n_current, n_expired) {counts[FILL:]}")
    label = ("statistics BASIC" if stats else "statistics OFF") + (
        ", state.obs.sample.every=1" if obs else
        ", state.obs.enabled=false")
    lat_line(np, f"S17 config 1 ({label})", lat, wall, S17_TIMED * B1,
             B1 * (8 + 4 + 1 + 4 + 8 + 4 + 4))
    ev_s = S17_TIMED * B1 / wall
    clock = [1000 + 10 * len(sends)]

    def more():
        for _ in range(S17_PROF):
            rt.get_input_handler("S").send_columns(
                config_rows(np, rng),
                timestamps=np.full(B1, clock[0], np.int64))
            clock[0] += 10
        rt.flush()
    copies = s17_copies(torch, more, S17_PROF)
    print(f"S17 config 1 ({label}): {copies['d2h']:.2f} "
          f"device-to-host and {copies['h2d']:.2f} host-to-device copies a "
          f"send (profiler memcpy records over {S17_PROF} sends); "
          f"fill_probe launches {launches['fill_probe']}, plain calls "
          f"{plain['fill_probe']} [{card}]")
    return mgr, rt, launches, plain, ev_s, copies


def s17_scrape_silent(torch, mgr, rt):
    """Prometheus text, health() and state_report() of a live app: no
    device fetch (`core/event.py` device_get counted) and no device
    activity in the profiler's trace."""
    from siddhi_tpu_torch.core import event as tev
    from siddhi_tpu_torch.observability import render_prometheus
    calls = [0]
    orig = tev.device_get

    def counted(x):
        calls[0] += 1
        return orig(x)
    tev.device_get = counted
    try:
        out = {}

        def scrape():
            out["text"] = render_prometheus(mgr.runtimes)
            out["health"] = rt.health()
            out["state"] = rt.state_report()
        cp = s17_copies(torch, scrape, 1)
    finally:
        tev.device_get = orig
    if calls[0] or cp["device_events"]:
        fail(f"S17: the scrape surfaces touched the device ({calls[0]} "
             f"fetches, {cp['device_events']} device events)")
    if "siddhi_state_occupancy" not in out["text"] or \
            not out["health"]["live"]:
        fail("S17: the scrape surfaces reported nothing")
    return out


def s17_state_masks(torch, srcs, counts, dev):
    """The JAX layout's alive masks of a state's fill sources: bool[cap]
    each, its first `count` rows alive (what the reference's probe
    reduces)."""
    return [torch.arange(s.cap, device=dev) < int(c)
            for s, c in zip(srcs, counts)]


def s17_probe_states(torch, np, dev):
    """W1's timeBatch state after its 8 filling sends and HP1's hop state
    after its 6, each with numpy's count of its alive rows from the state
    brought to the host (its counters; W1's also held to the state's host
    mirror of its fills)."""
    from siddhi_tpu_torch.kernels.time_batch import PEND, PREV
    out = []
    mgr = s17_manager(dev, S17_OFF)
    rt = mgr.create_siddhi_app_runtime(W1_QL)
    rt.start()
    rng = np.random.default_rng(83)
    for i in range(W1_FILL):
        rt.get_input_handler("TempStream").send_columns(*w1_send(np, rng, i))
    rt.flush()
    qr = rt.query_runtimes["w1"]
    st = qr.state[0]
    meta = st.meta.cpu().numpy()
    fills = [int(meta[PEND]), int(meta[PREV])]
    if fills != [st.h_pend, st.h_prev] or not 0 < sum(fills):
        fail(f"S17 W1: meta fills {fills} differ from the host mirror "
             f"{st.h_pend}, {st.h_prev}")
    out.append(("W1 timeBatch (2 x 2^21 rows)", qr.planned.window, st,
                fills))
    mgr2 = s17_manager(dev, S17_OFF)
    rt2 = mgr2.create_siddhi_app_runtime(HP1_QL)
    rt2.start()
    rng = np.random.default_rng(165)
    for i in range(HP1_FILL):
        rt2.get_input_handler("SensorStream").send_columns(
            *hp1_send(np, rng, i))
    rt2.flush()
    qr2 = rt2.query_runtimes["hp1"]
    st2 = qr2.state[0]
    n2 = int(st2.meta.cpu().numpy()[0])
    if not 0 < n2 <= st2.b_ts[0].shape[0]:
        fail(f"S17 HP1: {n2} rows in the hop buffer")
    out.append(("HP1 hop buffers (2^20 rows)", qr2.planned.window, st2,
                [n2]))
    return out, (mgr, mgr2)


def s17_time_probe(torch, np, dev, label, window, wstate, host_counts,
                   card):
    """K33 on one state: its counts equal to the plain version's and to
    the host's count, its CUDA-graph time beside the plain version's, its
    bound, the library call's (`count_nonzero` over the JAX layout's
    masks) and K33 in mask mode over those masks.  Returns the record."""
    from siddhi_tpu_torch.kernels import fill_probe as fp
    srcs = window.fill_sources(wstate)
    k = fp.launch(srcs)
    p = fp.fill_counts_plain(srcs)
    torch.cuda.synchronize()
    kh, ph = k.cpu().tolist(), p.cpu().tolist()
    if kh != ph:
        fail(f"S17 {label}: K33 {kh} != plain {ph}")
    if kh != [int(x) for x in host_counts]:
        fail(f"S17 {label}: K33 {kh} != the host's count {host_counts}")
    masks = s17_state_masks(torch, srcs, kh, dev)
    msrcs = [fp.mask(m) for m in masks]
    km = fp.launch(msrcs).cpu().tolist()
    lib = torch.stack([m.count_nonzero() for m in masks]).cpu().tolist()
    if km != kh or lib != kh:
        fail(f"S17 {label}: mask mode {km}, count_nonzero {lib}, K33 {kh}")
    n = len(srcs)
    reads = sum(8 if s.kind == "count" else 16 for s in srcs)
    r = {"ms": graph_ms(torch, lambda: fp.launch(srcs), 50),
         "plain_ms": event_timer(torch, lambda: fp.fill_counts_plain(srcs),
                                 20),
         "library_ms": event_timer(torch, lambda: torch.stack(
             [m.count_nonzero() for m in masks]), 20),
         "mask_ms": graph_ms(torch, lambda: fp.launch(msrcs), 50),
         **bound(reads + 8 * n)}
    mb = bound(sum(s.cap for s in srcs) + 8 * n)
    r["mask_bound_ms"] = mb["bound_ms"]
    print(f"S17 K33 on {label}: counts {kh} (caps "
          f"{[s.cap for s in srcs]}) == plain == host; kernel "
          f"{r['ms']:.5f} ms (graph replay), plain {r['plain_ms']:.5f} ms, "
          f"bound {r['bound_ms']:.7f} ms by {r['bound_by']} ({r['bytes']} "
          f"bytes: launch-bound); over the JAX layout's masks: K33 mask "
          f"mode {r['mask_ms']:.5f} ms, bound {mb['bound_ms']:.5f} ms "
          f"({mb['bytes']} bytes), count_nonzero {r['library_ms']:.5f} ms "
          f"[{card}]")
    return r


def s17_flagship_arm(torch, np, dev, on, card):
    """Phase 70, one arm: the flagship at full width (2^20 keys, 131,072
    keys x 4 events a send) with the observatory on (its default) or
    off: a warm sweep, SWEEPS timed sweeps.  The hotness feed's host time
    (`_stateobs_feed_group`: the per-key counts and the C feed) is summed
    over the timed sends.  Returns (ev/s, feed ms a send,
    hotness snapshot or None)."""
    from siddhi_tpu_torch.core import runtime as trt
    from siddhi_tpu_torch.kernels import pattern_step as ps
    mgr = s17_manager(dev, {} if on else S17_OFF)
    rt = mgr.create_siddhi_app_runtime(FLAGSHIP_QL.format(n_keys=N_KEYS))
    matches = [0]
    rt.add_batch_callback("flagship", lambda ts, p: matches.__setitem__(
        0, matches[0] + p["n_current"]))
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
    feed_ns = [0]
    orig = trt._stateobs_feed_group

    def timed_feed(*a):
        t = time.perf_counter_ns()
        orig(*a)
        feed_ns[0] += time.perf_counter_ns() - t
    for b in range(blocks):
        send(b)
    rt.flush()
    warm = matches[0]
    ps.reset_counts()
    trt._stateobs_feed_group = timed_feed
    lat = []
    try:
        t0 = time.perf_counter()
        for _ in range(SWEEPS):
            for b in range(blocks):
                tb = time.perf_counter()
                send(b)
                lat.append(time.perf_counter() - tb)
        rt.flush()
        wall = time.perf_counter() - t0
    finally:
        trt._stateobs_feed_group = orig
    got = matches[0] - warm
    if got != SWEEPS * N_KEYS:
        fail(f"S17 flagship ({'on' if on else 'off'}): {got} matches, "
             f"expected {SWEEPS * N_KEYS}")
    check_launched(f"S17 flagship ({'on' if on else 'off'})",
                   {"pattern_step": ps.launches},
                   {"pattern_step": ps.plain_calls}, ("pattern_step",))
    n_sends = SWEEPS * blocks
    events = n_sends * BATCH * 4
    lat_ms = np.array(lat) * 1e3
    hot = rt.state_report()["hotness"].get("flagship")
    feed_ms = feed_ns[0] / 1e6 / n_sends
    print(f"S17 flagship (observatory {'on' if on else 'off'}): {events} "
          f"events in {wall:.3f} s -> {events / wall:.0f} ev/s; per-send "
          f"p50 {float(np.percentile(lat_ms, 50)):.3f} ms p99 "
          f"{float(np.percentile(lat_ms, 99)):.3f} ms over {n_sends} sends; "
          f"hotness feed {feed_ms:.3f} ms a send (host); matches {got} "
          f"[{card}]")
    mgr.shutdown()
    return events / wall, feed_ms, hot


def slice17_phases(torch, np, dev):
    """Phases 68-70 (statistics and the state observatory): config 1's
    two arms (69), K33 against its plain version, the host and the
    library on W1's, HP1's and config 1's states (68, config 1's ring from
    69's first arm), the flagship's two arms (70).  Returns the K33
    record."""
    from siddhi_tpu_torch.kernels import fill_probe as fp
    t0 = time.perf_counter()
    card = card_line()

    def took(what):
        torch.cuda.empty_cache()
        print(f"slice 17 {what}: {time.perf_counter() - t0:.1f} s")
    # -- phase 69: config 1, statistics and the observatory off, then
    # statistics on with the observatory off, then both on.  Statistics on
    # route the query's rows into its output stream to count them (as the
    # JAX package does for an `insert into` stream no one reads), so the
    # probe's copies are held to the arm of the same statistics level
    arms = {}
    for key, stats, obs in (("off", False, False), ("stats", True, False),
                            ("on", True, True)):
        mgr, rt, la, pa, ev_s, cp = s17_config1_arm(torch, np, dev, stats,
                                                    obs, card)
        arms[key] = (la, pa, ev_s, cp)
        if key != "on":
            mgr.shutdown()
            if la["fill_probe"] or pa["fill_probe"]:
                fail(f"S17 config 1 {key}: the probe ran")
    mgr_on, rt_on = mgr, rt
    l_on, p_on, ev_on, cp_on = arms["on"]
    ev_off, cp_off = arms["off"][2], arms["off"][3]
    check_launched("S17 config 1 on", l_on, p_on,
                   ("filter_compact", "time_window", "group_agg",
                    "fill_probe"))
    if cp_on["d2h"] != arms["stats"][3]["d2h"] or cp_off["d2h"] != 2:
        fail(f"S17 config 1: device-to-host copies a send: "
             f"{cp_on['d2h']} with the probe, {arms['stats'][3]['d2h']} "
             f"at the same statistics level without it, {cp_off['d2h']} "
             f"with statistics off (two header fetches expected)")
    ring = rt_on.query_runtimes["q"].state[0]
    head, tail = (int(x) for x in ring.meta[:2].cpu().tolist())
    scr = s17_scrape_silent(torch, mgr_on, rt_on)
    wf = scr["state"]["structures"]["q"]["window_fill"]
    if not (wf["occupancy"] == tail - head == FILL * B1 and
            wf["capacity"] == WINDOW):
        fail(f"S17 config 1: window_fill {wf}, the ring holds "
             f"{tail - head} rows (closed form {FILL * B1})")
    print(f"S17 config 1: state_report window_fill {wf['occupancy']} of "
          f"{wf['capacity']} rows == the ring's count on the host == "
          f"{FILL} x {B1}; device-to-host copies a send {cp_on['d2h']:.2f} "
          f"with the probe, {arms['stats'][3]['d2h']:.2f} without it at the "
          f"same statistics level, {cp_off['d2h']:.2f} with statistics off; "
          f"Prometheus, health() and state_report() touched the device 0 "
          f"times; ev/s statistics + probe {ev_on:.0f}, statistics alone "
          f"{arms['stats'][2]:.0f}, both off {ev_off:.0f} ({ev_on / ev_off:.3f}x, "
          f"the probe {ev_on / arms['stats'][2]:.3f}x) [{card}]")
    took("phase 69 done")
    # -- phase 68: K33 on W1's, HP1's and config 1's states -----------------
    res = {}
    states, mgrs = s17_probe_states(torch, np, dev)
    states.append(("config 1 ring (2^24 rows)",
                   rt_on.query_runtimes["q"].planned.window, ring,
                   [tail - head]))
    for label, window, wstate, host in states:
        res[label] = s17_time_probe(torch, np, dev, label, window, wstate,
                                    host, card)
    for m in mgrs:
        m.shutdown()
    mgr_on.shutdown()
    took("phase 68 done")
    # -- phase 70: the flagship, observatory on and off, in the order on,
    # off, off, on (a process's first runs pay warm-ups the later ones do
    # not) ----------------------------------------------------------------
    runs = [s17_flagship_arm(torch, np, dev, on, card)
            for on in (True, False, False, True)]
    ev_fon = (runs[0][0] + runs[3][0]) / 2
    ev_foff = (runs[1][0] + runs[2][0]) / 2
    feed_ms = (runs[0][1] + runs[3][1]) / 2
    feed_off = (runs[1][1] + runs[2][1]) / 2
    hot = runs[3][2]
    if hot is None or runs[0][2] != hot or runs[1][2] is not None or \
            runs[2][2] is not None:
        fail(f"S17 flagship: hotness {[r[2] for r in runs]}")
    if hot["distinct"] != N_KEYS:
        fail(f"S17 flagship: {hot['distinct']} distinct keys, expected "
             f"{N_KEYS}")
    print(f"S17 flagship (means of the two runs of each arm): observatory "
          f"on {ev_fon:.0f} ev/s, off {ev_foff:.0f} ev/s "
          f"({ev_fon / ev_foff:.3f}x); hotness feed {feed_ms:.3f} ms a send "
          f"({feed_off:.4f} ms off: the memoized check); hotness.flagship "
          f"distinct {hot['distinct']}, hot_share_1pct "
          f"{hot['hot_share_1pct']}, total {hot['total']} [{card}]")
    took("phase 70 done")
    main_rec = res["config 1 ring (2^24 rows)"]
    return [{"name": "fill_probe", "route": "cuda",
             "source": "siddhi_tpu_torch/csrc/fill_probe.cu",
             "replaces": "siddhi_tpu/observability/stateobs.py:472",
             "launches": l_on["fill_probe"], "max_abs_err": 0.0,
             "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
             "bound_ms": main_rec["bound_ms"],
             "bound_by": main_rec["bound_by"],
             "library_ms": main_rec["library_ms"]}]


if __name__ == "__main__":
    main()
