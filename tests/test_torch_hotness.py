"""The port's key-hotness tracker (`observability/stateobs.py` KeyHotness,
its per-key work in `native/staging.c` `sg_hot_update`) against the JAX
package's numpy / dict class: `snapshot()`, `top(64)`, `estimate`,
`distinct`, `total` and the space-saving entries in insertion order,
exactly, on seeded Zipf(1.2) and uniform traces with keys up to 2^20, on
batches with dead keys, single-key batches (the reference's scalar fast
path) and a trace built so that tied minimum counts decide the victim.
The Python fallback (`_feed_py`, used without the native library) is held
to the same results.
"""
import numpy as np
import pytest

from siddhi_tpu.observability.stateobs import KeyHotness as JaxHotness
from siddhi_tpu_torch.native import LIB
from siddhi_tpu_torch.observability.stateobs import KeyHotness

CAP = 1 << 20


def _batches(kind, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(8):
        if kind == "zipf":
            keys = (rng.zipf(1.2, 4096) - 1) % CAP
        elif kind == "uniform":
            keys = rng.integers(0, CAP, 4096)
        else:
            keys = rng.integers(0, 200, 64)
        k, c = np.unique(keys, return_counts=True)
        if b == 2:
            k, c = k[:1], c[:1]              # the scalar fast path
        if b == 5:                           # dead keys and empty counts
            k = np.concatenate([k, [-1, 5]])
            c = np.concatenate([c, [3, 0]])
        out.append((k, c))
    return out


def _tie_batches():
    """64 keys of count 1 fill the top-K, then a key of count 2 and fresh
    keys: each fresh key must evict the FIRST count-1 key in insertion
    order, and the replaced key moves to the end."""
    out = [(np.arange(64), np.ones(64, np.int64))]
    out.append((np.array([10]), np.array([1])))       # 10 -> count 2
    for k in (1000, 1001, 1002):
        out.append((np.array([k]), np.array([1])))
    out.append((np.array([2000, 2001, 0, 10]), np.array([1, 1, 1, 1])))
    return out


def _feed(h, batches, py):
    for k, c in batches:
        if py:
            h.total += h._feed_py(np.asarray(k, np.int64),
                                  np.asarray(c, np.int64))
        else:
            h.update(k, c)


def _same(a, b):
    assert b.snapshot() == a.snapshot()
    assert b.top(64) == a.top(64)
    assert (b.distinct, b.total) == (a.distinct, a.total)
    assert list(b._ss.items()) == list(a._ss.items())
    probe = list(range(0, CAP, 4099)) + [k for k, _ in a.top(64)]
    assert [b.estimate(k) for k in probe] == [a.estimate(k) for k in probe]


@pytest.mark.parametrize("py", [False, True], ids=["c", "python"])
@pytest.mark.parametrize("kind", ["zipf", "uniform", "small", "ties"])
def test_equals_the_jax_class(kind, py):
    if not py:
        assert LIB is not None
    batches = _tie_batches() if kind == "ties" else _batches(kind)
    a, b = JaxHotness(CAP), KeyHotness(CAP)
    for k, c in batches:
        a.update(k, c)
    _feed(b, batches, py)
    _same(a, b)
    if kind == "ties":
        ss = list(b._ss)
        # fresh keys evict the count-1 keys in insertion order (0 .. 5;
        # 10 holds count 2) and sit at the end in arrival order: 0 comes
        # back as a fresh key and evicts 5
        assert ss[-6:] == [1000, 1001, 1002, 2000, 2001, 0]
        assert not {1, 2, 3, 4, 5} & set(ss) and b._ss[10] == 3


def test_capacity_bounds_the_distinct_bitmap():
    """Keys at or past the allocator capacity feed the sketch and the
    top-K but not the distinct bitmap, as in the reference."""
    a, b = JaxHotness(100), KeyHotness(100)
    k, c = np.array([5, 99, 100, 5000]), np.array([1, 2, 3, 4])
    a.update(k, c)
    b.update(k, c)
    _same(a, b)
    assert b.distinct == 2


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ties_over_many_calls_and_mixed_feeds(seed):
    """Many small batches with counts of 1 and 2 over a few hundred keys
    (ties at the least count on nearly every replacement), fed to one
    tracker through the C feed and the Python fallback in turn: the C
    feed's cached least count and cursor stay exact across calls and
    across entries the fallback rewrote."""
    rng = np.random.default_rng(seed)
    a, b = JaxHotness(CAP), KeyHotness(CAP)
    for i in range(300):
        k = rng.integers(0, 300, int(rng.integers(1, 40)))
        k, _ = np.unique(k, return_counts=True)
        c = rng.integers(1, 3, k.shape[0])
        a.update(k, c)
        _feed(b, [(k, c)], py=(i % 7 == 3))
    _same(a, b)
