"""trino_tpu_torch.ops.dense_groupby against the JAX reference.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode on the CPU, as tests/test_dense_groupby.py runs it) and through the
port's wrapper on CPU tensors, which runs the kernel's plain PyTorch
version. Everything compared is an integer, so the tolerance is zero:
the reference's ``hi * 65536 + lo`` must equal the port's limb totals
elementwise, and both reconstructions must agree exactly.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against this plain version there, and ``python3 chip_smoke.py``
does so at full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.ops import dense_groupby as R
from trino_tpu_torch import _kernels
from trino_tpu_torch.ops import dense_groupby as D

N = 1 << 15

# (G, (nonneg, bits) per column, pair128 per column, value makers)
PLANS = {
    # the slice's shape: one nonneg 20-bit column over 4096 groups
    "a": (4096, [(True, 20)], [False],
          lambda r, n: [r.integers(0, 1 << 20, n)]),
    # one signed 64-bit column with exact 128-bit sums (sign lane)
    "b": (128, [(False, 64)], [True],
          lambda r, n: [r.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)]),
    # three columns, mixed sign and width, plan.m near 4096
    "c": (8192, [(True, 30), (False, 64), (True, 62)], [False, True, True],
          lambda r, n: [r.integers(0, 1 << 30, n),
                        r.integers(-(1 << 40), 1 << 40, n),
                        r.integers(0, 1 << 62, n)]),
}


def _inputs(name, seed=0):
    G, cols, pair, make = PLANS[name]
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, G, N)
    # ~10% dead rows (bin == G), as a filter leaves them
    bins = np.where(rng.random(N) < 0.9, bins, G).astype(np.int32)
    vals = [v.astype(np.int64) for v in make(rng, N)]
    rplan = R.DensePlan(
        G=G, cols=tuple(R.DenseCol(*c) for c in cols), pair128=tuple(pair)
    )
    tplan = D.DensePlan(
        G=G, cols=tuple(D.DenseCol(*c) for c in cols), pair128=tuple(pair)
    )
    return rplan, tplan, bins, vals


@pytest.mark.parametrize("name", sorted(PLANS))
def test_limb_totals_match_reference(name):
    rplan, tplan, bins, vals = _inputs(name)
    assert tplan.m == rplan.m and tplan.lane_tables() == rplan.lane_tables()
    hi, lo = R.dense_groupby_device(
        rplan, jnp.asarray(bins), [jnp.asarray(v) for v in vals], interpret=True
    )
    want = np.asarray(hi).astype(np.int64) * 65536 + np.asarray(lo).astype(np.int64)
    lt = D.dense_groupby_device(
        tplan, torch.from_numpy(bins), [torch.from_numpy(v) for v in vals]
    )
    assert lt.dtype == torch.int64 and tuple(lt.shape) == (tplan.m, 128)
    np.testing.assert_array_equal(lt.numpy(), want)

    # host reconstruction: python-int sums and counts, equal exactly
    r_sums, r_counts = R.reconstruct(rplan, hi, lo)
    t_sums, t_counts = D.reconstruct(tplan, lt)
    assert t_sums == r_sums
    np.testing.assert_array_equal(t_counts, r_counts)

    # device reconstruction, with a two-key stride layout
    G = tplan.G
    kmins, kstrides, kranges = [3, -5], [G // 128, 1], [128, G // 128]
    r_keys, r_cols, r_cnt = R.reconstruct_device(
        rplan, hi, lo, jnp.asarray(kmins, jnp.int64),
        jnp.asarray(kstrides, jnp.int64), jnp.asarray(kranges, jnp.int64),
    )
    t_keys, t_cols, t_cnt = D.reconstruct_device(
        tplan, lt, torch.tensor(kmins), torch.tensor(kstrides),
        torch.tensor(kranges),
    )
    for a, b in zip(r_keys + r_cols + [r_cnt], t_keys + t_cols + [t_cnt]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_cpu_tensors_run_the_plain_version():
    _, tplan, bins, vals = _inputs("a", seed=3)
    launches = _kernels.LAUNCHES["dense_groupby"]
    plain = _kernels.PLAIN_CALLS["dense_groupby"]
    lt = D.dense_groupby_device(
        tplan, torch.from_numpy(bins), [torch.from_numpy(v) for v in vals]
    )
    assert _kernels.LAUNCHES["dense_groupby"] == launches  # no kernel here
    assert _kernels.PLAIN_CALLS["dense_groupby"] == plain + 1
    # counts lane: every live row counted once in its bin
    _, counts = D.reconstruct(tplan, lt)
    want = np.bincount(bins, minlength=tplan.G + 1)[: tplan.G]
    np.testing.assert_array_equal(counts, want)


@pytest.mark.parametrize(
    "bad",
    ["int64 bins", "int32 values", "short values", "column count"],
)
def test_wrapper_rejects_bad_inputs(bad):
    _, tplan, bins, vals = _inputs("a", seed=4)
    b = torch.from_numpy(bins)
    v = [torch.from_numpy(x) for x in vals]
    if bad == "int64 bins":
        b = b.to(torch.int64)
    elif bad == "int32 values":
        v = [x.to(torch.int32) for x in v]
    elif bad == "short values":
        v = [x[:-1] for x in v]
    else:
        v = v + v
    with pytest.raises(ValueError):
        D.dense_groupby_device(tplan, b, v)


def test_lane_ops_cover_every_limb():
    """The kernel's lane descriptors: limb j of a column reads bit shift
    8j of the full 64-bit value, then the sign lane, the count lane and
    zero padding to a multiple of 8 lanes."""
    plan = D.DensePlan(
        G=128, cols=(D.DenseCol(True, 20), D.DenseCol(False, 64)),
        pair128=(False, True),
    )
    cols, ops = D.lane_ops(plan)
    assert cols[:3] == [0, 0, 0] and ops[:3] == [0, 8, 16]
    assert cols[3:11] == [1] * 8 and ops[3:11] == [8 * j for j in range(8)]
    assert (cols[11], ops[11]) == (1, D._OP_SIGN)
    assert ops[12] == D._OP_COUNT
    assert ops[13:] == [D._OP_ZERO] * (len(ops) - 13) and len(ops) % 8 == 0

