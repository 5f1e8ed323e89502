"""The port's key-space router (`siddhi_tpu_torch/sharding/router.py`)
against the JAX package's `siddhi_tpu.sharding.router.ShardRouter` on
seeded slots, for n in {2, 4, 8}: the layout arithmetic, the re-bucketing
permutation and the staging-time grouping, array for array; the
divisibility error; the accessors on runtimes of both packages."""
import numpy as np
import pytest

from siddhi_tpu.sharding import router as jax_router
from siddhi_tpu_torch.sharding import ShardMesh, router as port_router

NS = [2, 4, 8]


def slots_of(seed, cap, size=300):
    rng = np.random.default_rng(seed)
    s = rng.integers(-1, cap, size).astype(np.int32)
    valid = rng.random(size) > 0.2
    return s, valid


@pytest.mark.parametrize("n", NS)
def test_layout_matches_jax(n):
    cap = 16 * n
    j, t = jax_router.ShardRouter(n, cap), port_router.ShardRouter(n, cap)
    assert (t.n_shards, t.capacity, t.block) == \
        (j.n_shards, j.capacity, j.block)
    slots = np.arange(cap)
    for fn in ("shard_of", "local_of", "state_row", "slot_of_row"):
        np.testing.assert_array_equal(getattr(t, fn)(slots),
                                      getattr(j, fn)(slots))


@pytest.mark.parametrize("n", NS)
def test_rebucket_index_matches_jax(n):
    cap = 48
    for m in (1, 2, 4, 8):
        if cap % m:
            continue
        np.testing.assert_array_equal(
            port_router.ShardRouter(n, cap).rebucket_index(
                port_router.ShardRouter(m, cap)),
            jax_router.ShardRouter(n, cap).rebucket_index(
                jax_router.ShardRouter(m, cap)))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_matches_jax(n, seed):
    cap = 32 * n
    slots, valid = slots_of(seed, cap)
    jt = jax_router.ShardRouter(n, cap).group(slots, valid)
    tt = port_router.ShardRouter(n, cap).group(slots, valid)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)


def test_divisibility_error():
    with pytest.raises(ValueError, match="not divisible"):
        port_router.ShardRouter(4, 30)
    with pytest.raises(ValueError, match="n_shards"):
        port_router.ShardRouter(0, 8)
    with pytest.raises(ValueError, match="re-bucket"):
        port_router.ShardRouter(2, 8).rebucket_index(
            port_router.ShardRouter(2, 16))


def test_mesh_and_accessors():
    mesh = ShardMesh(["cpu"] * 4)
    assert mesh.n == 4 and mesh.first.type == "cpu"
    assert port_router.shard_count(mesh) == 4
    assert port_router.shard_count(None) == 1
    import siddhi_tpu_torch
    ql = """
    define stream S (key long, v int);
    partition with (key of S)
    begin
      @capacity(keys='32')
      @info(name='p') from S select key, sum(v) as t insert into O;
      @info(name='k') from S#window.length(2) select key, sum(v) as t
      insert into O2;
      @info(name='e') from every e1=S[v == 1] -> e2=S[v == 2]
      select e1.key as k insert into O3;
    end;
    """
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(ql, mesh=mesh)
    assert port_router.shard_count(rt) == 4
    p, k, e = (rt.query_runtimes[q] for q in "pke")
    assert port_router.mesh_of(p) is mesh
    assert port_router.group_router_for(p).capacity == 4096
    assert port_router.keyed_mesh_of(k) is mesh
    assert port_router.router_for(k).capacity == 32
    assert port_router.group_router_for(k) is None
    assert port_router.router_for(e).block == 8
    with pytest.raises(ValueError):
        ShardMesh([])
