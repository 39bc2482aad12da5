"""trino_tpu_torch's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a GPU: a
CUDA kernel has no CPU mode. The file imports neither JAX nor the
reference package, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Integer results throughout: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch import _kernels
from trino_tpu_torch.ops import dense_groupby as D

N = 1 << 15

# (G, (nonneg, bits) per column, pair128 per column, value makers): the
# slice's shape (a), a signed 128-bit sum (b), mixed columns near M=4096 (c)
PLANS = {
    "a": (4096, [(True, 20)], [False],
          lambda r, n: [r.integers(0, 1 << 20, n)]),
    "b": (128, [(False, 64)], [True],
          lambda r, n: [r.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)]),
    "c": (8192, [(True, 30), (False, 64), (True, 62)], [False, True, True],
          lambda r, n: [r.integers(0, 1 << 30, n),
                        r.integers(-(1 << 40), 1 << 40, n),
                        r.integers(0, 1 << 62, n)]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PLANS))
def test_dense_groupby_kernel_matches_plain(cuda, name):
    G, cols, pair, make = PLANS[name]
    rng = np.random.default_rng(5)
    plan = D.DensePlan(
        G=G, cols=tuple(D.DenseCol(*c) for c in cols), pair128=tuple(pair)
    )
    # ~10% dead rows (bin == G), as a filter leaves them
    bins = np.where(rng.random(N) < 0.9, rng.integers(0, G, N), G)
    b = torch.from_numpy(bins.astype(np.int32)).to(cuda)
    v = [torch.from_numpy(x.astype(np.int64)).to(cuda) for x in make(rng, N)]
    before = _kernels.LAUNCHES["dense_groupby"]
    lt = D.dense_groupby_device(plan, b, v)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dense_groupby"] == before + 1
    assert torch.equal(lt, D.dense_groupby_plain(plan, b, v))


@pytest.mark.cuda
def test_group_by_query_launches_the_kernel(cuda):
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.testing import LocalQueryRunner

    rng = np.random.default_rng(7)
    k = rng.integers(0, 4096, N)
    v = rng.integers(0, 1 << 20, N)
    runner = LocalQueryRunner(device=cuda)
    runner.session.set("execution_mode", "distributed")
    runner.session.set("stream_scan_threshold_rows", 1 << 14)
    mem = runner.catalogs.get("memory")
    mem.create_table(
        "default", "t",
        TableSchema("t", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))),
    )
    mem.insert("default", "t", batch_from_numpy([T.BIGINT] * 2, [k, v]))
    before = _kernels.LAUNCHES["dense_groupby"]
    rows, _ = runner.execute(
        "select k, sum(v), count(*) from memory.default.t group by k"
    )
    assert _kernels.LAUNCHES["dense_groupby"] == before + 1
    counts = np.bincount(k, minlength=4096)
    sums = np.bincount(k, weights=v, minlength=4096).astype(np.int64)  # < 2^53
    want = [(g, int(sums[g]), int(counts[g])) for g in np.flatnonzero(counts)]
    assert sorted(rows) == want
