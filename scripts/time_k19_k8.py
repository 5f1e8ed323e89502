"""Time K19 `frequent` at an FQ1 send and K8 `block_nfa` at S1 and
S1-wide on one CUDA GPU, from the checkout at --root (default: this
repository), after holding both against their plain versions with that
checkout's own chip_smoke.py comparisons (phase 37c for K19, phase 14 for
K8; any difference exits nonzero).

    python3 scripts/time_k19_k8.py [--root DIR] [--reps N]

Prints one JSON line: the card, each kernel's ms a launch (CUDA-graph
replays between CUDA events, `--reps` replays, three rounds), its plain
version's ms, its bound and, for K19, the device time of each kernel its
launch runs (torch.profiler).  To compare two commits on one card, unpack
the other one into a directory that .gitignore lists (`git archive`) and
run this script on both in one call, in the order old, new, new, old.
K8 is also timed on two PATTERN edge cases of this repository's
chip_smoke.py (`K8_EDGE_CASES` at `K8_EDGE_E` events: first matches past
event 96 of a chunk, seeds that never match on falling prices), whatever
the checkout timed.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def edge_cases():
    """K8_EDGE_CASES, K8_EDGE_E and k8_edge_send of this repository's
    chip_smoke.py (loaded under another name: the checkout's own
    chip_smoke module may lack them)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_edges", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K8_EDGE_CASES, mod.K8_EDGE_E, mod.k8_edge_send


def time_k8_edge(torch, np, cs, dev, ql, sends, reps):
    """K8 at one edge case's second send, from the state its first leaves:
    the kernel against its plain version (state, header and rows), then
    timed."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import block_nfa as bn
    planned = SiddhiManager(device=dev).create_siddhi_app_runtime(ql) \
        .query_runtimes["q"].planned
    step = planned.steps["S"]
    state = planned.init_state(1)[0]
    for i, (cols, ts, sel) in enumerate(sends):
        dcols = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                      for c in cols)
        raw_ts = torch.from_numpy(ts).to(dev)
        dsel = torch.from_numpy(sel[None, :]).to(dev)
        args = (dcols, raw_ts, dsel,
                torch.zeros(1, dtype=torch.int32, device=dev), int(ts.max()))
        before = cs.clone_state(state)
        a = step.plain(cs.clone_state(state), (), *args)
        b = step.kernel(state, (), *args)
        torch.cuda.synchronize()
        _, hdr = cs.compare_steps(torch, a, b, f"edge send {i}", False)
        state = b[0]
    work = cs.clone_state(before)
    kp = step.kernel_plan

    def restore():
        cs.restore_into(work, before)
    return {"ms": [cs.graph_ms(torch, lambda: bn.launch(
                kp, work, dcols, raw_ts, None, dsel, int(ts.max())), reps,
                restore) for _ in range(3)],
            "completions": hdr[0]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from siddhi_tpu_torch.kernels import _nvcc
    from siddhi_tpu_torch.kernels import frequent as fq
    if not cs.__file__.startswith(root) or not fq.__file__.startswith(root):
        sys.exit(f"imported {cs.__file__} / {fq.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    _nvcc.build_all(("frequent", "block_nfa", "filter_compact"))
    e19, t_fq = cs.compare_frequent(torch, np, dev)
    e8, _, t8 = cs.compare_block_kernel(torch, np, dev)
    res = {"root": root, "card": cs.card_line(), "k19_err": e19,
           "k8_err": e8}

    saved, arr, n, kp = t_fq
    work = saved.clone()
    out = fq.launch(work, arr, n, kp)
    n_out, na = int(out.ts.shape[0]), int(n)
    rb = 8 + 4 + sum(c.element_size() for c in saved.cols)
    n_cur = int((out.kind == 0).sum())
    nk = saved.keys.shape[1]

    def restore():
        work.copy_from(saved)
    res["k19"] = {
        "ms": [cs.graph_ms(torch, lambda: fq.launch(work, arr, n, kp,
                                                    n_out=n_out),
                           args.reps, restore) for _ in range(3)],
        "plain_ms": cs.event_timer(torch, lambda: fq.plain(work, arr, n, kp),
                                   1, restore),
        **cs.bound(na * (rb + 8) + n_out * cs.row_bytes(out) + n_cur * rb +
                   2 * saved.n * 8 * (1 + nk)),
        "shape": f"{saved.n} counters, {na} arrivals, {n_out} rows out"}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            restore()
            fq.launch(work, arr, n, kp, n_out=n_out)
        torch.cuda.synchronize()
    res["k19"]["device_us_by_kernel"] = {
        e.key: e.device_time_total / 3 for e in prof.key_averages()
        if e.device_time_total > 0}
    for label in ("S1-wide", "S1"):
        t = [cs.time_block_kernel(torch, np, dev, t8, label)
             for _ in range(3)]
        res[f"k8 {label}"] = {"ms": [x["ms"] for x in t],
                              "plain_ms": t[0]["plain_ms"],
                              "bound_ms": t[0]["bound_ms"],
                              "bound_by": t[0]["bound_by"]}
    cases, E, send = edge_cases()
    rng = np.random.default_rng(211)
    for name in ("late first match", "falling prices"):
        res[f"k8 {name}"] = time_k8_edge(
            torch, np, cs, dev, cases[name],
            [send(np, rng, name, E, i) for i in range(2)], args.reps)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
