"""TPC-H Q12-Q22 through trino_tpu_torch against the JAX reference, on
the CPU: the second half of ``test_torch_tpch.py``'s query test, in a file
of its own so that two test processes share its cost. The reference's
rows are its committed answers at ``tpch.tiny``
(``tpch_tiny_answers.json``). Rows and column types must be equal
exactly.
"""

import pytest

from test_torch_tpch import check_query, reference_rows, runners  # noqa: F401

QUERIES_HERE = range(12, 23)


@pytest.fixture(scope="module")
def want(runners):  # noqa: F811
    return reference_rows(runners, QUERIES_HERE)


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("q", QUERIES_HERE)
def test_tpch_query_matches_reference(runners, want, q, mode):  # noqa: F811
    check_query(runners, want, q, mode)
