"""Block-parallel NFA advance for single-key (non-partitioned) patterns
(PyTorch port of `siddhi_tpu/core/pattern_block.py`).

For the common simple-chain shape (every atom min = max = 1, no logical
pairs, no absent atoms) the advance of the single key over a block of E
events is computed in S-1 stages per W-event chunk instead of E ticks:

  threads = P slab states + one candidate per in-chunk seed event.
  Stage s evaluates filter_s over the [T, W] (thread x event) grid; a
  PATTERN thread advances at its first matching event (cumsum first-true),
  a SEQUENCE thread must match the next valid event after its previous
  capture (strict continuity) or die.

Chunks run in order; pending threads at a chunk boundary re-enter the
P-slot slab by free rank, and seeds that find no free slot count into
`dropped`.  The reference documents its divergences from the scan path
(`pattern.py` tick), and this port keeps them, because the reference's
block step is what it must equal:

- pendings inside a chunk are unbounded (only the chunk boundary meets
  the P-slot cap);
- after a non-every pattern completes (`done`), the chunk's bookkeeping
  freezes at the completion;
- a seed filter that reads another atom's captures sees zeros;
- the capture timestamp slabs go stale in the carried state, and the
  written-back `count` and `lmask` are zero.

Values move between threads as the reference's one-hot sums move them: a
float32 -0.0 captured through a stage or a slab refill comes out +0.0 (a
NaN keeps its bits).

On a CUDA device the step is kernel K8 (`kernels/block_nfa.py`); this
module is its plain version and the CPU path.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import event as ev
from .pattern import PatternExec, PatternSpec
from ..kernels.in_probe import probe_env
from .window import NO_WAKEUP, Rows

CHUNK = 128
BIG = (2 ** 63 - 1) // 4


def block_eligible(spec: PatternSpec) -> bool:
    """Simple chains only: single-count atoms, no logical pairs, no absent
    atoms (timer machinery), PATTERN or SEQUENCE.  Everything else keeps
    the fully general scan path."""
    for a in spec.atoms:
        if a.absent or a.partner is not None or a.is_count:
            return False
        if a.capture_depth != 1:
            return False
    return spec.state_type in ("PATTERN", "SEQUENCE")


def _take(c, oh, dim):
    """The reference's one-hot take (select + sum) along `dim`, where `oh`
    holds at most one true per row: a float -0.0 comes out +0.0 (a sum
    with zeros), a NaN keeps its bits (taken as a gather, not a sum, so
    the device and the host agree bit for bit)."""
    if c.dtype == torch.bool:
        return torch.any(oh & c, dim=dim)
    if not c.dtype.is_floating_point:
        return torch.sum(torch.where(oh, c, torch.zeros(
            (), dtype=c.dtype, device=c.device)), dim=dim, dtype=c.dtype)
    c, oh = torch.broadcast_tensors(c, oh)
    idx = torch.argmax(oh.to(torch.int8), dim=dim, keepdim=True)
    got = torch.gather(c, dim, idx).squeeze(dim)
    got = torch.where(torch.any(oh, dim=dim) & (got != 0), got,
                      torch.zeros((), dtype=c.dtype, device=c.device))
    return got


def _bind(env, ref, cols):
    env[ref] = cols
    env[f"{ref}@0"] = cols
    env[f"{ref}@-1"] = cols


def make_block_step(spec: PatternSpec, pexec: PatternExec, sel, schemas,
                    packer, stream_id: str, compact_rows: int):
    """The (packed, sel_state, raw_cols, raw_ts, sel_idx, key_ref, now) ->
    (packed', sel_state', out, wake) step, with the scan step's signature,
    so the runtime drives either.  The blobs are updated in place."""
    S = spec.n_states
    atoms = spec.atoms
    P = pexec.P
    schema = schemas[stream_id]
    a0 = atoms[0]
    emit_refs = pexec.emit_refs
    is_seq = spec.state_type == "SEQUENCE"

    def zeros_of(a, n, dev):
        return tuple(torch.zeros((n,), dtype=d, device=dev)
                     for d in schemas[a.stream_id].dtypes)

    def chunk_advance(carry, ev_cols, ts, valid, base):
        """One W-event chunk: seeds + S-1 stages + refill."""
        (active, pos, start_ts, entry_ts, slab_caps, seed_on, done,
         dropped) = carry
        dev = ts.device
        W = ts.shape[0]
        T = P + W
        iota_w = torch.arange(W, dtype=torch.int32, device=dev)
        i64 = torch.int64

        # ---- seeds ---------------------------------------------------------
        if a0.stream_id == stream_id:
            filt0 = pexec._filters[a0.ckey]
            if filt0 is None:
                c0 = torch.ones((W,), dtype=torch.bool, device=dev)
            else:
                env0 = {"__ts__": ts, **probes}
                for a in atoms:
                    _bind(env0, a.ref, ev_cols if a.ref == a0.ref
                          else zeros_of(a, W, dev))
                c0 = torch.broadcast_to(filt0.fn(env0), (W,))
            c0 = c0 & valid & torch.logical_not(done)
            if a0.every:
                seed_fire = c0
            else:
                cs0 = torch.cumsum(c0.to(torch.int32), 0)
                seed_fire = c0 & (cs0 == 1) & seed_on
                seed_on = seed_on & torch.logical_not(torch.any(c0))
        else:
            seed_fire = torch.zeros((W,), dtype=torch.bool, device=dev)

        if S == 1:
            # single-atom pattern: every seed completes at once
            comp_valid = torch.cat([torch.zeros((P,), dtype=torch.bool,
                                                device=dev), seed_fire])
            comp_idx = torch.cat([torch.zeros((P,), dtype=i64, device=dev),
                                  base + iota_w.to(i64)])
            comp_ts = torch.cat([torch.zeros((P,), dtype=i64, device=dev),
                                 ts])
            caps_t = {
                a.ref: tuple(
                    torch.cat([torch.zeros((P,), dtype=c.dtype, device=dev),
                               c])
                    for c in (ev_cols if a.ref == a0.ref
                              else zeros_of(a, W, dev)))
                for a in atoms}
            if not a0.every:
                done = done | torch.any(comp_valid)
            ncarry = (active, pos, start_ts, entry_ts, slab_caps, seed_on,
                      done, dropped)
            return ncarry, (comp_valid, comp_idx, comp_ts, caps_t)

        # ---- thread arrays [T] ---------------------------------------------
        alive = torch.cat([active, seed_fire])
        cur_pos = torch.cat([pos, torch.ones((W,), dtype=torch.int32,
                                             device=dev)])
        avail = torch.cat([torch.zeros((P,), dtype=torch.int32, device=dev),
                           iota_w + 1])
        start = torch.cat([start_ts, ts])
        entry = torch.cat([entry_ts, ts])
        caps_t = {}
        for a in atoms:
            seed_cols = ev_cols if (a.ref == a0.ref and
                                    a0.stream_id == stream_id) \
                else zeros_of(a, W, dev)
            caps_t[a.ref] = tuple(
                torch.cat([sc, tc.to(sc.dtype)])
                for sc, tc in zip(slab_caps[a.ref], seed_cols))

        comp_valid = torch.zeros((T,), dtype=torch.bool, device=dev)
        comp_idx = torch.zeros((T,), dtype=i64, device=dev)
        comp_ts = torch.zeros((T,), dtype=i64, device=dev)

        if is_seq:
            # next_valid[k] = first valid event index >= k (W if none)
            idxs = torch.where(valid, iota_w, W)
            next_valid = torch.flip(torch.cummin(torch.flip(idxs, (0,)),
                                                 0).values, (0,))

            def req_of(av):
                oh_av = iota_w[None, :] == torch.clamp(av, 0, W - 1)[:, None]
                nv = _take(torch.broadcast_to(next_valid[None, :], (T, W)),
                           oh_av, 1)
                exists = (av < W) & (nv < W)
                return nv, exists

        gate = torch.logical_not(done)
        # ---- stages (unrolled: S is small) ---------------------------------
        for s in range(1, S):
            a = atoms[s]
            eligible = alive & (cur_pos == s)
            if a.stream_id != stream_id:
                if is_seq:
                    # strict continuity: any remaining valid event kills a
                    # thread waiting on another stream's atom
                    _nv, exists = req_of(avail)
                    alive = alive & torch.logical_not(eligible & exists)
                continue
            filt = pexec._filters[a.ckey]
            env: Dict[str, Any] = {"__ts__": ts[None, :], **probes}
            for other in atoms:
                _bind(env, other.ref,
                      tuple(c[None, :] for c in ev_cols)
                      if other.ref == a.ref else
                      tuple(c[:, None] for c in caps_t[other.ref]))
            if filt is None:
                cond = torch.ones((T, W), dtype=torch.bool, device=dev)
            else:
                cond = torch.broadcast_to(filt.fn(env), (T, W))
            m = cond & valid[None, :]
            m = m & (iota_w[None, :] >= avail[:, None])
            m = m & eligible[:, None]
            m = m & gate
            if spec.within is not None:
                m = m & (ts[None, :] - start[:, None] <= spec.within)
            if is_seq:
                nv, exists = req_of(avail)
                first = m & (iota_w[None, :] ==
                             torch.clamp(nv, 0, W - 1)[:, None]) & \
                    exists[:, None]
                hit = torch.any(first, dim=1)
                # a next event exists but does not match: the thread dies
                alive = alive & torch.logical_not(
                    eligible & exists & torch.logical_not(hit))
            else:
                cs = torch.cumsum(m.to(torch.int32), dim=1)
                first = m & (cs == 1)
                hit = torch.any(first, dim=1)
            j_hit = _take(torch.broadcast_to(iota_w[None, :].to(i64), (T, W)),
                          first, 1)
            ts_hit = _take(torch.broadcast_to(ts[None, :], (T, W)), first, 1)
            caps_t[a.ref] = tuple(
                torch.where(hit, _take(torch.broadcast_to(c[None, :], (T, W)),
                                       first, 1), old)
                for c, old in zip(ev_cols, caps_t[a.ref]))
            avail = torch.where(hit, (j_hit + 1).to(torch.int32), avail)
            entry = torch.where(hit, ts_hit, entry)
            if s == S - 1:
                comp_valid = comp_valid | hit
                comp_idx = torch.where(hit, base + j_hit, comp_idx)
                comp_ts = torch.where(hit, ts_hit, comp_ts)
                alive = alive & torch.logical_not(hit)
            else:
                cur_pos = torch.where(hit, s + 1, cur_pos).to(torch.int32)

        if not a0.every:
            # only the FIRST completion emits; it latches `done`
            cstar = torch.min(torch.where(comp_valid, comp_idx, BIG))
            comp_valid = comp_valid & (comp_idx == cstar)
            done = done | torch.any(comp_valid)

        # ---- slab refill: surviving seed threads -> free slots -------------
        slab_alive = alive[:P]
        seed_pending = alive[P:]
        free = torch.logical_not(slab_alive)
        rank = torch.cumsum(seed_pending.to(torch.int32), 0) - 1       # [W]
        free_rank = torch.cumsum(free.to(torch.int32), 0) - 1          # [P]
        hot = free[:, None] & seed_pending[None, :] & \
            (free_rank[:, None] == rank[None, :])                     # [P,W]
        has = torch.any(hot, dim=1)
        dropped = dropped + torch.clamp(
            torch.sum(seed_pending.to(i64)) - torch.sum(free.to(i64)), min=0)

        def pull(seed_field, old_field):
            got = _take(seed_field[None, :], hot, 1)
            return torch.where(has, got, old_field)

        ncarry = (
            slab_alive | has,
            pull(cur_pos[P:], cur_pos[:P]).to(torch.int32),
            pull(start[P:], start[:P]),
            pull(entry[P:], entry[:P]),
            {a.ref: tuple(pull(tc[P:], tc[:P]) for tc in caps_t[a.ref])
             for a in atoms},
            seed_on, done, dropped)
        return ncarry, (comp_valid, comp_idx, comp_ts, caps_t)

    probes: Dict[str, Any] = {}

    def step(packed, sel_state, raw_cols, raw_ts, sel_idx, key_ref, now,
             in_tabs=None):
        # `x in Table` probes of this step's filters (reference: the
        # block step's probe_env over the shipped snapshots)
        probes.clear()
        probes.update(probe_env(in_tabs or {}))
        b32, b64, scalars = packed
        dev = b32.device
        B = raw_ts.shape[0]
        csel = torch.clamp(sel_idx[0], 0, B - 1).long()                # [E]
        cols = tuple(c[csel].to(d) for c, d in zip(raw_cols, schema.dtypes))
        ts = raw_ts[csel]
        valid = sel_idx[0] >= 0
        st = packer.unpack(b32, b64, scalars)
        E = ts.shape[0]
        W = min(CHUNK, E)
        C = (E + W - 1) // W
        pad = C * W - E
        if pad:
            cols = tuple(torch.cat([c, torch.zeros((pad,), dtype=c.dtype,
                                                   device=dev)]) for c in cols)
            ts = torch.cat([ts, torch.zeros((pad,), dtype=ts.dtype,
                                            device=dev)])
            valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                                  device=dev)])
        T = P + W

        carry = (
            st.active[:, 0], st.pos[:, 0], st.start_ts[:, 0],
            st.entry_ts[:, 0],
            {a.ref: tuple(c[:, 0, 0] for c in st.caps[a.ckey][1])
             for a in atoms},
            st.seed_on[0], st.done[0], st.dropped)
        comps = []
        for c in range(C):
            sl = slice(c * W, (c + 1) * W)
            carry, out_c = chunk_advance(carry, tuple(x[sl] for x in cols),
                                         ts[sl], valid[sl], c * W)
            comps.append(out_c)
        (factive, fpos, fstart, fentry, fcaps, fseed_on, fdone,
         fdropped) = carry
        if spec.within is not None:
            factive = factive & (now - fstart <= spec.within)

        # ---- write the slab back in packed form ----------------------------
        ncapd = {}
        for a in atoms:
            old_ts, _old_cols = st.caps[a.ckey]
            ncapd[a.ckey] = (old_ts, tuple(c[:, None, None]
                                           for c in fcaps[a.ref]))
        nst = st._replace(
            active=factive[:, None], pos=fpos[:, None],
            count=torch.zeros_like(st.count),
            lmask=torch.zeros_like(st.lmask),
            start_ts=fstart[:, None], entry_ts=fentry[:, None],
            seed_on=fseed_on.reshape(1), done=fdone.reshape(1),
            dropped=fdropped, caps=ncapd)
        nb32, nb64, nscal = packer.pack(nst)
        b32.copy_(nb32)
        b64.copy_(nb64)

        # ---- emission: order completions by arrival, run the selector ------
        comp_valid = torch.stack([x[0] for x in comps])              # [C,T]
        comp_idx = torch.stack([x[1] for x in comps])
        comp_ts = torch.stack([x[2] for x in comps])
        CT = C * T
        thread_rank = torch.arange(T, dtype=torch.int64,
                                   device=dev)[None, :]
        key = torch.where(comp_valid, comp_idx * (T + 1) + thread_rank,
                          BIG).reshape(CT)
        order = torch.argsort(key, stable=True)
        o_valid = comp_valid.reshape(CT)[order]
        o_ts = comp_ts.reshape(CT)[order]

        env: Dict[str, Any] = {"__ts__": o_ts, "__now__": now}
        for a in atoms:
            if emit_refs is not None and a.ref not in emit_refs:
                continue
            ncol = len(comps[0][3][a.ref])
            ocols = tuple(
                torch.stack([x[3][a.ref][j] for x in comps]).reshape(CT)[order]
                for j in range(ncol))
            _bind(env, a.ref, ocols)
        rows = Rows(ts=o_ts,
                    kind=torch.full((CT,), ev.CURRENT, dtype=torch.int32,
                                    device=dev),
                    valid=o_valid,
                    seq=torch.arange(CT, dtype=torch.int64, device=dev),
                    gslot=torch.zeros((CT,), dtype=torch.int32, device=dev),
                    cols=())
        sel_state, out = sel.process(sel_state, rows, env)
        sel_state, out = cut_rows(out, compact_rows, sel_state)
        return (b32, b64, nscal), sel_state, out, NO_WAKEUP

    return step


def cut_rows(out, compact_rows: int, sel_state):
    """The valid-first cut of arrival-ordered rows to `compact_rows`: valid
    rows past the cap are dropped and counted.  Returns (sel_state,
    (n_valid, n_dropped, ts, kind, valid, cols))."""
    ots, okind, ovalid, ocols = out
    CT = ots.shape[0]
    R = min(compact_rows, CT)
    if R < CT:
        rankv = torch.cumsum(ovalid.to(torch.int32), 0) - 1
        keep = ovalid & (rankv < R)
        n_valid = torch.sum(keep.to(torch.int64))
        n_dropped = torch.sum(ovalid.to(torch.int64)) - n_valid
        out = (ots, okind, keep, ocols)
    else:
        n_valid = torch.sum(ovalid.to(torch.int64))
        n_dropped = torch.zeros((), dtype=torch.int64, device=ots.device)
    return sel_state, (n_valid, n_dropped) + tuple(out)
