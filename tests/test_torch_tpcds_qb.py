"""TPC-DS queries through trino_tpu_torch against the reference's
committed rows, on the CPU: part 2 of three (``test_torch_tpcds_qa.py``
says how).
"""

import pytest
import torch

from test_torch_tpcds_qa import check_query, answers, port  # noqa: F401

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)


QUERIES_HERE = [2, 7, 13, 20, 26, 30, 34, 40, 43, 48, 53, 58, 61, 65, 69, 74, 82, 87, 91, 94, 97]


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("q", QUERIES_HERE)
def test_tpcds_query_matches_reference(port, answers, q, mode):  # noqa: F811
    check_query(port, answers, q, mode)
