"""TPC-DS Q98 (a window), Q87 (EXCEPT) and Q97 (FULL OUTER) through
trino_tpu_torch against the reference's interpreter run live on the same
``tpcds.tiny`` tables, in both execution modes: the second half of
``test_torch_tpcds.py``'s live test, in a file of its own so that two
test processes share the reference's compilation."""

import pytest
import torch

from test_torch_tpcds import runners, test_live_rows_match_reference as live  # noqa: F401

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)


@pytest.mark.parametrize("q", (98, 87, 97))
def test_live_rows_match_reference(runners, q):  # noqa: F811
    live(runners, q)
