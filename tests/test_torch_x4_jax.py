"""X4's expression window cases in a value and a range partition
(`chip_smoke.X12_CASES`) recomputed on the JAX package: its events equal
the ones `chip_smoke.py` embeds, which `test_torch_window_expr.py` holds
the port to.  The top-level cases, and two partition cases, are
recomputed in `test_torch_window_expr.py`, the keyed frequent ones in
`test_torch_keyed_freq_expr.py`; this file holds the rest, so that every
X4 case runs through both packages.  Each case is one app, compiled once.
"""
import pytest

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from test_torch_window_expr import CASES, JAX_RECHECK

PARTITIONED = [c for c in CASES
               if c[0].split()[0] != "top" and c[0] not in JAX_RECHECK]


@pytest.mark.parametrize("name,ql,qname,sends,want", PARTITIONED,
                         ids=[c[0] for c in PARTITIONED])
def test_partition_case_is_the_jax_events(name, ql, qname, sends, want):
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
