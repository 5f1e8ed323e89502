"""The port's copied front end parses exactly as the JAX package's does.

Every shipped sample app and every SiddhiQL string of the audit corpus
(`siddhi_tpu/analysis/corpus.py`) parses in both packages; the two parse
trees must be structurally equal (same node kinds, same fields, same
values).  Tolerance: none, the trees are compared exactly.
"""
import pytest

from siddhi_tpu.analysis import corpus as jcorpus
from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu_torch.compiler import SiddhiCompiler as TorchCompiler

CORPUS = jcorpus.corpus()


def tree(x):
    """A package-independent structural dump: class name + fields."""
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    if isinstance(x, (list, tuple)):
        return [tree(v) for v in x]
    if isinstance(x, dict):
        return {k: tree(v) for k, v in x.items()}
    if hasattr(x, "__dict__"):
        return (type(x).__name__,
                {k: tree(v) for k, v in sorted(vars(x).items())})
    return repr(x)


@pytest.mark.parametrize("key,ql", [(k, q) for k, q, _ in CORPUS],
                         ids=[k for k, _, _ in CORPUS])
def test_corpus_parses_identically(key, ql):
    j = JaxCompiler.parse(ql)
    t = TorchCompiler.parse(ql)
    assert tree(t) == tree(j)
    assert tree(j)[0] == "SiddhiApp"


def test_flagship_template_parses_identically():
    ql = jcorpus.FLAGSHIP_QL_TEMPLATE.format(async_ann="", pipe_ann="",
                                             n_keys=4096, slots=4)
    assert tree(TorchCompiler.parse(ql)) == tree(JaxCompiler.parse(ql))


def test_parse_errors_agree():
    bad = "define stream S (a int;\nfrom S select a insert into O;"
    with pytest.raises(Exception) as je:
        JaxCompiler.parse(bad)
    with pytest.raises(Exception) as te:
        TorchCompiler.parse(bad)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)
