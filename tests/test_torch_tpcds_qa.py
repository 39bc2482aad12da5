"""TPC-DS queries through trino_tpu_torch against the reference's
committed rows, on the CPU.

Each query of the corpus (``benchmarks/tpcds.py``) runs as spec text over
``tpcds.tiny`` through the port's local executor and through its
distributed (fragment) executor; its rows and column types must equal the
reference's answers committed in ``tpcds_tiny_answers.json`` (made by
``scripts/tpcds_answers.py`` with the reference's interpreter) exactly,
in ORDER BY order, rows whose ORDER BY keys tie as a multiset. No DOUBLE
column needs a tolerance: each is one division of exact integer sums or
counts. The 64 queries are split over three files
(``test_torch_tpcds_q{a,b,c}.py``) so that three test processes share
them.
"""

import pytest
import torch

from trino_tpu_torch.benchmarks import tpch as B
from trino_tpu_torch.benchmarks.tpcds import ANSWERS_TINY, queries
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def answers():
    data = B.load_answers(ANSWERS_TINY)
    assert data["schema"] == "tpcds.tiny"
    return data["queries"]


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner(device="cpu")


def check_query(port, answers, q, mode) -> None:
    """Query ``q`` through the port in ``mode`` gives the reference's
    committed rows and column types."""
    sql = queries("tpcds.tiny")[q]
    port.session.set("execution_mode", mode)
    try:
        res = port.engine.execute_statement(sql, port.session)
    finally:
        port.session.set("execution_mode", "local")
    want = answers[str(q)]
    assert [t.name for t in res.column_types] == want["types"], f"Q{q}"
    bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
    assert bad is None, f"Q{q} ({mode}): {bad}"
    if mode == "local":
        assert res.fragment_modes is None
    else:
        assert res.fragment_modes


QUERIES_HERE = [1, 6, 12, 19, 25, 29, 33, 38, 42, 46, 52, 56, 60, 64, 68, 73, 79, 84, 90, 93, 96, 99]


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("q", QUERIES_HERE)
def test_tpcds_query_matches_reference(port, answers, q, mode):
    check_query(port, answers, q, mode)
