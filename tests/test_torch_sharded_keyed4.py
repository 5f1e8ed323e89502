"""Sharding over the key axis (A14): the keyed windows of
`test_torch_sharded_ext.py` on the 4-shard meshes (the JAX package's
`Mesh(devs[:4])`, the port's `ShardMesh([cpu] * 4)`), compared exactly and
in order, and with the port's unsharded run, sorted."""
import pytest

from test_torch_sharded import both, flat
from test_torch_sharded_ext import CASES


@pytest.mark.parametrize("case", sorted(CASES))
def test_meshed_run_matches_jax_4(case):
    ql, feeds = CASES[case]
    j, t, u = both(ql, "q", feeds, 4)
    assert t == j
    assert flat(t) == flat(u)
    assert flat(t)
