"""X5's cases with index 1 mod 8 through both packages on the CPU (see
test_torch_pattern_x5_a.py for what is compared and the tolerance:
exact)."""
import pytest

from test_torch_pattern_x5_a import check, jax_events, share

CASES = share(1)


@pytest.fixture(scope="module")
def jax():
    return jax_events(CASES)


@pytest.mark.parametrize("spec", CASES, ids=[s[0] for s in CASES])
def test_x5_case(spec, jax):
    check(spec, jax)
