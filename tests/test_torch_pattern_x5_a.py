"""X5, the pattern corpus of chip_smoke.py's phase 52, through both
packages on the CPU: every app of tests/test_pattern.py,
test_pattern_corpus.py, test_sequence_corpus.py and test_absent_corpus.py
that the JAX package runs, the query guide's pattern examples and their
padded twins, and a leading absent atom with and without `every`, each at
the top level and inside a value partition with three keys a send.  The
JAX package's events are recomputed here in a module-scoped fixture (a
case whose narrow stream the reference cannot merge runs its padded
twin there) and must equal the port's events exactly (timestamps, row
values, callback order), and the events chip_smoke.py embeds.  The cases
split over eight files (this one and test_torch_pattern_x5_b.py to
test_torch_pattern_x5_h.py) by index, so that `--dist loadfile` spreads
them and each file's JAX runs stay under about 40 s on one worker; the
corpus's raise-checks are here."""
import pytest

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError
from siddhi_tpu_torch.compiler.tokenizer import SiddhiParserException

SPECS = chip_smoke.x5_specs()
WANT = {c[0]: c[4] for c in chip_smoke.X5_CASES}


FILES = 8


def share(r):
    return [s for i, s in enumerate(SPECS) if i % FILES == r]


def jax_events(specs):
    out = {}
    for name, ql, q, sends, twin in specs:
        jql, jsends = twin if twin is not None else (ql, sends)
        out[name] = chip_smoke.corpus_run(JaxManager(), jql, q, jsends)
    return out


def check(spec, jax):
    name, ql, q, sends, _ = spec
    got = chip_smoke.corpus_run(TorchManager(device="cpu"), ql, q, sends)
    assert jax[name] == WANT[name]
    assert got == jax[name]


CASES = share(0)


@pytest.fixture(scope="module")
def jax():
    return jax_events(CASES)


@pytest.mark.parametrize("spec", CASES, ids=[s[0] for s in CASES])
def test_x5_case(spec, jax):
    check(spec, jax)


@pytest.mark.parametrize("name,ql", chip_smoke.X5_RAISES,
                         ids=[r[0] for r in chip_smoke.X5_RAISES])
def test_x5_raise_checks_raise_in_the_port(name, ql):
    with pytest.raises((CompileError, SiddhiParserException)):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)
