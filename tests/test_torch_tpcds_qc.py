"""TPC-DS queries through trino_tpu_torch against the reference's
committed rows, on the CPU: part 3 of three (``test_torch_tpcds_qa.py``
says how).
"""

import pytest
import torch

from test_torch_tpcds_qa import check_query, answers, port  # noqa: F401

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)


QUERIES_HERE = [3, 9, 15, 21, 28, 32, 37, 41, 45, 50, 55, 59, 62, 66, 71, 76, 83, 88, 92, 95, 98]


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("q", QUERIES_HERE)
def test_tpcds_query_matches_reference(port, answers, q, mode):  # noqa: F811
    check_query(port, answers, q, mode)
