"""The general pattern NFA of the port against the JAX package's, step by
step, for the forms test_torch_pattern_general.py does not step (its
harness and tolerance: state blobs, overflow counter, emission header and
output rows exact, NaN equal to NaN and +0 to -0): `*` and `?` in a
sequence, and / or pairs, instant and timed absent pairs (timer steps
after each data step) and a leading absent atom."""
import pytest

from test_torch_pattern_general import FORMS, HERE, general_steps_agree

REST = [f for f in FORMS if f[0] not in HERE]


@pytest.mark.parametrize("name,slots,body", REST, ids=[f[0] for f in REST])
def test_general_steps_agree(name, slots, body):
    general_steps_agree(name, slots, body)
