"""The port's event model and host staging agree with the JAX package's.

Same events (made from a numpy seed, nulls in every type) go through
`pack` / `unpack` in both packages; the staged arrays and the decoded
events must be equal.  The copied `SlotAllocator` must resolve and group
the same key batches into identical (slots, key_idx, sel).  Tolerance:
none, everything is compared exactly.
"""
import numpy as np
import pytest
import torch

from siddhi_tpu.core import event as jev
from siddhi_tpu.core.keyslots import SlotAllocator as JaxAllocator
from siddhi_tpu.query_api.definition import StreamDefinition as JaxDef
from siddhi_tpu_torch.core import event as tev
from siddhi_tpu_torch.core.keyslots import SlotAllocator as TorchAllocator
from siddhi_tpu_torch.query_api.definition import StreamDefinition as TDef

TYPES = ["INT", "LONG", "FLOAT", "DOUBLE", "STRING", "BOOL"]


def schemas():
    jd, td = JaxDef("S"), TDef("S")
    for i, t in enumerate(TYPES):
        jd.attribute(f"a{i}", t)
        td.attribute(f"a{i}", t)
    return (jev.Schema(jd, jev.StringInterner()),
            tev.Schema(td, tev.StringInterner()))


def random_events(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        row = [int(rng.integers(-1000, 1000)),
               int(rng.integers(-2**40, 2**40)),
               float(np.float32(rng.normal())),
               float(np.float32(rng.normal() * 1e3)),
               ["IBM", "WSO2", "GOOG", ""][int(rng.integers(0, 4))],
               bool(rng.integers(0, 2))]
        for j in range(len(row)):
            if TYPES[j] != "BOOL" and rng.random() < 0.2:
                row[j] = None
        out.append(jev.Event(1000 + i, row))
    return out


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 33), (3, 200)])
def test_pack_unpack_round_trip(seed, n):
    js, ts = schemas()
    events = random_events(seed, n)
    jst = jev.pack_np(js, events)
    tst = tev.pack_np(ts, [tev.Event(e.timestamp, e.data) for e in events])
    assert tst.n == jst.n
    for a, b in zip((tst.ts, tst.kind, tst.valid) + tuple(tst.cols),
                    (jst.ts, jst.kind, jst.valid) + tuple(jst.cols)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jout = jev.unpack(js, jst.to_device(js))
    tout = tev.unpack(ts, tst.to_device(ts, torch.device("cpu")))
    assert [(k, e.timestamp, e.data) for k, e in tout] == \
        [(k, e.timestamp, e.data) for k, e in jout]
    # nulls survive the round trip as None, in every nullable type
    want = [[None if v is None else v for v in e.data] for e in events]
    assert [e.data for _, e in tout] == want


def test_dtypes_and_nulls_agree():
    for t in TYPES + ["OBJECT"]:
        assert str(tev.dtype_of(t)).split(".")[-1] == \
            np.dtype(jev.dtype_of(t)).name.replace("bool_", "bool")
        jn, tn = jev.null_value(t), tev.null_value(t)
        assert (jn != jn and tn != tn) or jn == tn
        assert tev.default_value(t) == jev.default_value(t)
        assert tev.np_dtype(t) == jev.np_dtype(t)
    for n in (1, 8, 9, 131072, 131073, 2097152):
        assert tev.bucket_size(n) == jev.bucket_size(n)


def test_null_mask_on_tensors():
    x = torch.tensor([1, tev.NULL_INT, 3], dtype=torch.int32)
    assert tev.null_mask(x, "INT").tolist() == [False, True, False]
    f = torch.tensor([0.5, float("nan")])
    assert tev.null_mask(f, "DOUBLE").tolist() == [False, True]
    s = torch.tensor([-1, 0], dtype=torch.int32)
    assert tev.null_mask(s, "STRING").tolist() == [True, False]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slots_and_group_identical(seed):
    rng = np.random.default_rng(seed)
    cap = 4096
    ja, ta = JaxAllocator(cap, name="j"), TorchAllocator(cap, name="t")
    for step in range(6):
        n = int(rng.integers(1, 6000))
        if step % 3 == 2:
            # a contiguous block, each key 4 times (the flagship's shape)
            k0 = int(rng.integers(0, 3000))
            keys = np.repeat(np.arange(k0, k0 + n // 4 + 1,
                                       dtype=np.int64), 4)
        else:
            keys = rng.integers(0, 3500, n).astype(np.int64)
        valid = rng.random(keys.shape[0]) < 0.9
        js, jk, jsel = ja.slots_and_group([keys], valid, pad=cap)
        tsl, tk, tsel = ta.slots_and_group([keys], valid, pad=cap)
        np.testing.assert_array_equal(tsl, js)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tsel, jsel)
        assert ta.version == ja.version
