"""The plain versions of kernels K31 `shard_route` and K32 `shard_merge`
(the ones the port runs on the CPU, and the card's kernels' references)
against the JAX package's own shard_map bodies on the 8-device CPU mesh
that `tests/conftest.py` forces: the ownership arithmetic of
`_shard_plain_step` and `_shard_keyed_step`, `_merge_rows`, the keyed
step's `dmerge`, and `_shard_local`'s header psum, wake pmin and scalar
re-replication.  The JAX bodies run with stand-in steps that report what
each device saw or hand each device its own new state.  Every dtype the
merges take (f32, f64, i32, i64, bool), with -0.0, NaN and +-inf planted;
the tolerance is bitwise (floats compared by their bit patterns)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from siddhi_tpu.core import planner as jplanner
from siddhi_tpu.core import pattern_planner as jpp
from siddhi_tpu.core.steputil import shard_map
from siddhi_tpu_torch.kernels import shard_merge as k32, shard_route as k31

NS = [8, 4]


def mesh_of(n):
    devs = np.array(jax.devices())
    if devs.size < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(devs[:n], ("shard",))


def bits(a):
    """A comparable view of an array: floats by their bit patterns."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


class _Ex:
    """A stand-in window / selector for the JAX shard steps' specs."""

    def __init__(self, state):
        self.state = state

    def init_state(self):
        return self.state


# ---------------------------------------------------------------------------
# K31: the ownership arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_route_plain_matches_the_jax_body(n):
    """`_shard_plain_step` with a step that emits, per row it owns, its
    local slot and its device index: the merged rows give each row's
    owner and local slot, which K31's plain mode must give."""
    rng = np.random.default_rng(n)
    B = 96
    gslot = rng.integers(-1, 64, B).astype(np.int32)
    valid = rng.random(B) > 0.2

    def step(state, ts, kind, valid, cols, gslot, now, in_tabs, pslots):
        dev = lax.axis_index("shard").astype(jnp.int32)
        return state, (ts, kind, valid,
                       (gslot, jnp.where(valid, dev, 0))), \
            jnp.asarray(2**62, jnp.int64)

    wst = jnp.asarray(0, jnp.int64)
    fn = jplanner._shard_plain_step(step, mesh_of(n), _Ex(()), _Ex(wst),
                                    64)
    _, (_, _, ovalid, (local, owner)), _ = fn(
        (wst, ()), jnp.zeros(B, jnp.int64), jnp.zeros(B, jnp.int32),
        jnp.asarray(valid), (), jnp.asarray(gslot), jnp.asarray(0),
        (), ())
    lvalid, tlocal = k31.route_plain(torch.from_numpy(gslot),
                                     torch.from_numpy(valid), n)
    np.testing.assert_array_equal(lvalid.any(0).numpy(), np.asarray(ovalid))
    rows = np.nonzero(np.asarray(ovalid))[0]
    t_owner = lvalid.int().argmax(0).numpy()
    np.testing.assert_array_equal(t_owner[rows], np.asarray(owner)[rows])
    np.testing.assert_array_equal(
        tlocal.numpy()[t_owner[rows], rows], np.asarray(local)[rows])
    # a shard that does not own a row's slot gives it local slot 0
    owned = (gslot.astype(np.int64) % n)[None, :] == np.arange(n)[:, None]
    assert (tlocal.numpy()[~owned] == 0).all()
    np.testing.assert_array_equal(
        (tlocal.numpy() * lvalid.numpy()).sum(0)[rows],
        np.asarray(local)[rows])


@pytest.mark.parametrize("n", NS)
def test_route_keyed_matches_the_jax_body(n):
    """`_shard_keyed_step` with a step that emits, per key row, the local
    row it was given and its device index where that row is not the drop
    sentinel K: each key row's owner and local row must be K31's."""
    K = 16 * n
    rng = np.random.default_rng(10 + n)
    Kb = 40
    key_idx = rng.integers(0, K + 1, Kb).astype(np.int32)   # K = padding

    def kstep(state, ts, kind, valid, cols, gslot, key_l, sel_idx, now,
              in_tabs=()):
        dev = lax.axis_index("shard").astype(jnp.int32)
        own = key_l < K
        return state, (jnp.zeros(Kb, jnp.int64), jnp.zeros(Kb, jnp.int32),
                       own, (jnp.where(own, key_l, 0),
                             jnp.where(own, dev, 0))), \
            jnp.asarray(2**62, jnp.int64)

    fn = jplanner._shard_keyed_step(kstep, mesh_of(n), K)
    slab = jnp.zeros((K,), jnp.int32)
    _, (_, _, ovalid, (local, owner)), _ = fn(
        (slab, ()), jnp.zeros(4, jnp.int64), jnp.zeros(4, jnp.int32),
        jnp.ones(4, bool), (), jnp.zeros(4, jnp.int32),
        jnp.asarray(key_idx), jnp.zeros((Kb, 1), jnp.int32),
        jnp.asarray(0), ())
    key_l = k31.route_keyed(torch.from_numpy(key_idx), n, K).numpy()
    own = key_l != K // n
    np.testing.assert_array_equal(own.any(0), np.asarray(ovalid))
    assert (own.sum(0) <= 1).all()
    rows = np.nonzero(own.any(0))[0]
    t_owner = own.argmax(0)
    np.testing.assert_array_equal(t_owner[rows], np.asarray(owner)[rows])
    np.testing.assert_array_equal(key_l[t_owner[rows], rows],
                                  np.asarray(local)[rows])


def test_place_orders_rows_key_row_major():
    """Shard d's rows of key row k go after every row of the key rows
    before k, in the shard's order."""
    counts = torch.tensor([[2, 0, 0, 1, 0], [0, 3, 0, 0, 1],
                           [0, 0, 1, 0, 0]], dtype=torch.int64)
    pos = k31.place(counts, 8)
    assert pos.tolist() == [0, 1, 6, 2, 3, 4, 7, 5]
    with pytest.raises(ValueError):
        k31.place(counts, 7)


# ---------------------------------------------------------------------------
# K32 rows: _merge_rows
# ---------------------------------------------------------------------------

SPECIAL = {np.float32: [-0.0, np.nan, np.inf, -np.inf, 1.5],
           np.float64: [-0.0, np.nan, np.inf, -np.inf, 2.25],
           np.int32: [-2**31, 2**31 - 1, -1, 0, 7],
           np.int64: [-2**63, 2**63 - 1, -1, 0, 9],
           np.bool_: [True, False, True, True, False]}


def aligned_inputs(n, R, dtype, seed, one_owner=True):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        col = rng.random((n, R)) > 0.5
    elif np.issubdtype(dtype, np.floating):
        col = rng.standard_normal((n, R)).astype(dtype)
    else:
        col = rng.integers(-1000, 1000, (n, R)).astype(dtype)
    sp = np.array(SPECIAL[dtype], dtype)
    col[:, :len(sp)] = sp[None, :]
    col[:, len(sp):2 * len(sp)] = sp[None, :]
    if one_owner:
        owner = rng.integers(-1, n, R)      # -1: no shard owns the row
        valid = owner[None, :] == np.arange(n)[:, None]
    else:
        valid = rng.random((n, R)) > 0.5
    # the planted values on their owner, and masked under a non-owner
    valid[:, :len(sp)] = np.arange(n)[:, None] == 0
    valid[:, len(sp):2 * len(sp)] = False
    return col, valid


def jax_merge_rows(mesh, col, valid):
    def local(v, c):
        out = jplanner._merge_rows(v[0], c[0])
        vv = lax.psum(v[0].astype(jnp.int32), "shard") > 0
        return out, vv
    f = shard_map(local, mesh=mesh, in_specs=(P("shard"), P("shard")),
                  out_specs=(P(), P()))
    out, vv = jax.jit(f)(jnp.asarray(valid), jnp.asarray(col))
    return np.asarray(out), np.asarray(vv)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.bool_])
def test_merge_rows_matches_merge_rows(n, dtype):
    R = 64
    col, valid = aligned_inputs(n, R, dtype, 7)
    jo, jv = jax_merge_rows(mesh_of(n), col, valid)
    (to,), tv = k32.merge_rows(
        [(torch.from_numpy(col[d]),) for d in range(n)],
        [torch.from_numpy(valid[d]) for d in range(n)], R)
    np.testing.assert_array_equal(bits(to.numpy()), bits(jo))
    np.testing.assert_array_equal(tv.numpy(), jv)
    if np.issubdtype(dtype, np.floating):
        # an owned -0.0 comes out +0.0 (the owner's value plus zeros)
        assert np.signbit(to.numpy()[0]) == np.signbit(jo[0]) == False  # noqa


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_merge_rows_sums_several_owners_exactly(n, dtype):
    R = 48
    col, valid = aligned_inputs(n, R, dtype, 8, one_owner=False)
    jo, jv = jax_merge_rows(mesh_of(n), col, valid)
    (to,), tv = k32.merge_rows(
        [(torch.from_numpy(col[d]),) for d in range(n)],
        [torch.from_numpy(valid[d]) for d in range(n)], R)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.bool_])
def test_placed_rows_match_merge_rows(n, dtype):
    """Compacted shard rows placed by position merge as their aligned
    form does under `_merge_rows`."""
    R = 64
    col, valid = aligned_inputs(n, R, dtype, 9)
    jo, jv = jax_merge_rows(mesh_of(n), col, valid)
    cols, vals, pos = [], [], []
    for d in range(n):
        idx = np.nonzero(valid[d])[0]
        cols.append((torch.from_numpy(col[d][idx]),))
        vals.append(torch.ones(idx.shape[0], dtype=torch.bool))
        pos.append(torch.from_numpy(idx.astype(np.int64)))
    (to,), tv = k32.merge_rows(cols, vals, R, pos=pos)
    np.testing.assert_array_equal(bits(to.numpy()), bits(jo))
    np.testing.assert_array_equal(tv.numpy(), jv)


# ---------------------------------------------------------------------------
# K32 delta: dmerge and the scalar re-replication
# ---------------------------------------------------------------------------

def delta_inputs(n, L, dtype, seed, one_changer=True):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        old = rng.random(L) > 0.5
        new = np.repeat(old[None], n, 0)
        flip = rng.integers(-1, n, L)
        for d in range(n):
            new[d] = np.where(flip == d, ~old, old)
        return old, new
    if np.issubdtype(dtype, np.floating):
        old = rng.standard_normal(L).astype(dtype)
        fresh = rng.standard_normal((n, L)).astype(dtype)
    else:
        old = rng.integers(-500, 500, L).astype(dtype)
        fresh = rng.integers(-500, 500, (n, L)).astype(dtype)
    sp = np.array(SPECIAL[dtype], dtype)
    old[:len(sp)] = sp
    new = np.repeat(old[None], n, 0)
    if one_changer:
        changer = rng.integers(-1, n, L)
        for d in range(n):
            new[d] = np.where(changer == d, fresh[d], old)
    else:
        ch = rng.random((n, L)) > 0.5
        new = np.where(ch, fresh, old[None])
    if np.issubdtype(dtype, np.floating):
        # +inf -> 5 gives NaN; a NaN old stays NaN; -0.0 against +0.0 is
        # unchanged
        old[0], old[1], old[2] = dtype(0.0), np.nan, np.inf
        new[:, 0] = old[0]
        new[:, 1] = old[1]
        new[:, 2] = old[2]
        new[0, 0] = dtype(-0.0)
        new[n - 1, 2] = dtype(5.0)
        new[n - 1, 1] = dtype(3.0)
    return old, new


def jax_dmerge(mesh, old, new, K=8):
    """`_shard_keyed_step`'s dmerge, driven through the step: each device's
    stand-in keyed step hands back its row of `new` as its selector
    state."""
    n = new.shape[0]

    def kstep(state, ts, kind, valid, cols, gslot, key_l, sel_idx, now,
              in_tabs=()):
        wslab, _ = state
        mine = cols[0][lax.axis_index("shard")]
        return (wslab, (mine,)), (ts, kind, valid, ()), \
            jnp.asarray(2**62, jnp.int64)

    fn = jplanner._shard_keyed_step(kstep, mesh, K * n)
    (_, (merged,)), _, _ = fn(
        (jnp.zeros((K * n,), jnp.int32), (jnp.asarray(old),)),
        jnp.zeros(4, jnp.int64), jnp.zeros(4, jnp.int32),
        jnp.ones(4, bool), (jnp.asarray(new),), jnp.zeros(4, jnp.int32),
        jnp.zeros(2, jnp.int32), jnp.zeros((2, 1), jnp.int32),
        jnp.asarray(0), ())
    return np.asarray(merged)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.bool_])
def test_merge_delta_matches_dmerge(n, dtype):
    old, new = delta_inputs(n, 40, dtype, 3)
    j = jax_dmerge(mesh_of(n), old, new)
    t = k32.merge_delta(torch.from_numpy(old),
                        [torch.from_numpy(new[d]) for d in range(n)])
    np.testing.assert_array_equal(bits(t.numpy()), bits(j))
    if np.issubdtype(dtype, np.floating):
        assert np.isnan(t.numpy()[1]) and np.isnan(t.numpy()[2])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_merge_delta_finite_old(dtype):
    """`finite_old`: dmerge, except that a changed element whose old value
    is NaN or +-inf takes the changed copy (the keyed step's min / max
    identities)."""
    n = 4
    old, new = delta_inputs(n, 40, dtype, 5)
    j = jax_dmerge(mesh_of(n), old, new)
    t = k32.merge_delta(torch.from_numpy(old),
                        [torch.from_numpy(new[d]) for d in range(n)],
                        finite_old=True).numpy()
    changed = (new != old[None]).any(0)
    last = old.copy()
    for d in range(n):
        last = np.where(new[d] != old, new[d], last)
    odd = changed & ~np.isfinite(old)
    np.testing.assert_array_equal(bits(t[~odd]), bits(j[~odd]))
    np.testing.assert_array_equal(bits(t[odd]), bits(last[odd]))
    if np.issubdtype(dtype, np.floating):
        assert odd[1] and odd[2] and t[2] == 5.0


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_merge_delta_sums_several_changers_exactly(n, dtype):
    old, new = delta_inputs(n, 40, dtype, 4, one_changer=False)
    j = jax_dmerge(mesh_of(n), old, new)
    t = k32.merge_delta(torch.from_numpy(old),
                        [torch.from_numpy(new[d]) for d in range(n)])
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("n", NS)
def test_scalars_header_and_wake_match_shard_local(n):
    """`_shard_local` with a stand-in pattern body that hands each device
    its own scalar counters, header words and wake: the re-replicated
    scalars (unmasked delta), the psum'd header and the pmin'd wake."""
    rng = np.random.default_rng(n)
    old = np.array([5, -3], np.int64)
    new = old[None] + rng.integers(-4, 9, (n, 2))
    hdr = rng.integers(0, 100, (n, 2)).astype(np.int64)
    wakes = rng.integers(10, 10**9, n).astype(np.int64)

    def body(packed, sel_state, raw_cols, raw_ts, sel_idx, key_idx, now,
             in_tabs):
        b32, b64, scal = packed
        d = lax.axis_index("shard")
        mine = tuple(raw_cols[0][d, i] for i in range(2))
        h = raw_cols[1][d]
        out = (h[0], h[1], raw_ts[:1], raw_ts[:1], raw_ts[:1], raw_ts[:1])
        return (b32, b64, mine), sel_state, out, raw_cols[2][d]

    local = jpp._shard_local(body)
    f = shard_map(
        local, mesh=mesh_of(n),
        in_specs=((P(None, "shard"), P(None, "shard"), (P(), P())), (),
                  (P(), P(), P()), P(), P("shard"), P("shard"), P(), P()),
        out_specs=((P(None, "shard"), P(None, "shard"), (P(), P())), (),
                   (P(), P(), P("shard"), P("shard"), P("shard"),
                    P("shard")), P()))
    (_, _, scal), _, out, wake = jax.jit(f)(
        (jnp.zeros((1, n), jnp.int32), jnp.zeros((1, n), jnp.int64),
         tuple(jnp.asarray(x) for x in old)), (),
        (jnp.asarray(new), jnp.asarray(hdr), jnp.asarray(wakes)),
        jnp.zeros(4, jnp.int64), jnp.zeros((n, 1), jnp.int32),
        jnp.zeros(n, jnp.int32), jnp.asarray(0), ())
    for i in range(2):
        t = k32.merge_delta(torch.tensor(old[i]),
                            [torch.tensor(new[d, i]) for d in range(n)],
                            masked=False)
        assert int(t) == int(scal[i])
    th = k32.merge_header([torch.tensor([hdr[d, 0], hdr[d, 1], wakes[d]])
                           for d in range(n)], min_words=(2,))
    assert th.tolist() == [int(out[0]), int(out[1]), int(wake)]
