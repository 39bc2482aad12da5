"""trino_tpu_torch.ops.decimal128 against the JAX reference, bit for bit.

The same int64 inputs, made from a seed with numpy and salted with the
int64 edge values (INT64_MIN, -1, 2^63-1, the 32-bit limb borders), go
through each function of ``trino_tpu/ops/decimal128.py`` and its port;
the outputs must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.ops import decimal128 as R
from trino_tpu_torch.ops import decimal128 as D

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1
EDGES = [
    I64_MIN, I64_MIN + 1, -(1 << 32) - 1, -(1 << 32), -(1 << 31), -2, -1,
    0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32, I64_MAX - 1,
    I64_MAX,
]
N = 2048


def _lanes(seed: int, n: int = N) -> np.ndarray:
    """n int64 values: every edge value, then random bit patterns of
    random widths (so small and large magnitudes both occur)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 64, n)
    raw = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
    shifted = (raw.view(np.uint64) >> (64 - bits).astype(np.uint64)).view(np.int64)
    vals = np.where(rng.random(n) < 0.5, shifted, raw)
    vals[: len(EDGES)] = EDGES
    return vals


@pytest.fixture(scope="module")
def ab():
    a = _lanes(1)
    b = np.concatenate([np.asarray(EDGES * (N // len(EDGES))), _lanes(2)])[:N]
    # every edge against every edge, then random against random
    ea = np.repeat(np.asarray(EDGES), len(EDGES))
    eb = np.tile(np.asarray(EDGES), len(EDGES))
    return np.concatenate([ea, a]), np.concatenate([eb, b[::-1].copy()])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(port, ref):
    """Equal elementwise: a tensor or tuple of tensors against jax arrays."""
    if isinstance(port, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _same(p, r)
        return
    r = np.asarray(ref)
    p = port.numpy()
    assert p.shape == r.shape
    np.testing.assert_array_equal(p.astype(r.dtype), r)


def test_scalar_and_host_conversions(ab):
    a, b = ab
    ints = [int(x) * (1 << 40) + int(y) for x, y in zip(a[:500], b[:500])]
    ints += [(1 << 127) - 1, -(1 << 127), 0, -1]
    assert [D.int_to_pair(v) for v in ints] == [R.int_to_pair(v) for v in ints]
    pairs = [(int(x), int(y)) for x, y in zip(a, b)]
    assert [D.pair_to_int(*p) for p in pairs] == [R.pair_to_int(*p) for p in pairs]
    np.testing.assert_array_equal(D.wide_from_ints(ints), R.wide_from_ints(ints))
    arr = R.wide_from_ints(ints)
    assert D.wide_to_ints(arr) == R.wide_to_ints(arr) == ints
    assert D.wide_to_ints(_t(arr)) == ints


@pytest.mark.parametrize(
    "fn", ["mulhi_u64", "mul_i64_to_i128", "mul_i64_overflows", "widen_i64"]
)
def test_int64_products(ab, fn):
    a, b = ab
    if fn == "widen_i64":
        _same(D.widen_i64(_t(a)), R.widen_i64(jnp.asarray(a)))
        return
    _same(getattr(D, fn)(_t(a), _t(b)), getattr(R, fn)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("fn", ["add128", "compare128", "neg128", "mul128_by_i64"])
def test_pair_arithmetic(ab, fn):
    a, b = ab
    c, d = _lanes(3, a.shape[0]), _lanes(4, a.shape[0])[::-1].copy()
    if fn == "neg128":
        _same(D.neg128(_t(a), _t(b)), R.neg128(jnp.asarray(a), jnp.asarray(b)))
    elif fn == "mul128_by_i64":
        _same(
            D.mul128_by_i64(_t(a), _t(b), _t(c)),
            R.mul128_by_i64(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)),
        )
    else:
        args = [a, b, c, d]
        if fn == "compare128":  # ties on hi and on the whole value too
            args = [a, b, np.where(np.arange(a.shape[0]) % 3 == 0, a, c),
                    np.where(np.arange(a.shape[0]) % 5 == 0, b, d)]
        _same(
            getattr(D, fn)(*map(_t, args)),
            getattr(R, fn)(*map(jnp.asarray, args)),
        )


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_operands_wide(ab, ascending):
    a, b = ab
    port = D.sort_operands_wide(_t(a), _t(b), ascending)
    ref = R.sort_operands_wide(jnp.asarray(a), jnp.asarray(b), ascending)
    _same(tuple(port), tuple(ref))
    # the operands order values as signed 128-bit integers
    ints = [R.pair_to_int(x, y) for x, y in zip(a, b)]
    keys = list(zip(*(x.tolist() for x in port)))
    order = sorted(range(len(ints)), key=lambda i: keys[i])
    got = [ints[i] for i in order]
    assert got == sorted(ints, reverse=not ascending)


def _segments(n: int, groups: int, seed: int):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, groups, n))


def test_limb_sums_and_reconstruction(ab):
    a, b = ab
    n = a.shape[0]
    rng = np.random.default_rng(5)
    valid = rng.random(n) < 0.8
    gids = _segments(n, 7, 6)

    def ref_seg(x):  # one lane at a time
        return jnp.zeros(7, x.dtype).at[jnp.asarray(gids)].add(x)

    def port_seg(lanes):  # all lanes in one call
        x = torch.stack(lanes, dim=1)
        return torch.zeros((7, len(lanes)), dtype=x.dtype).index_add_(
            0, _t(gids), x
        )

    for v in (None, valid):
        rv = None if v is None else jnp.asarray(v)
        pv = None if v is None else _t(v)
        narrow_r = R.narrow_limb_sums(jnp.asarray(a), rv, ref_seg)
        narrow_p = D.narrow_limb_sums(_t(a), pv, port_seg)
        _same(narrow_p, narrow_r)
        wide_r = R.wide_limb_sums(jnp.asarray(a), jnp.asarray(b), rv, ref_seg)
        wide_p = D.wide_limb_sums(_t(a), _t(b), pv, port_seg)
        _same(wide_p, wide_r)
        _same(D.limb_sums_to_pair(narrow_p), R.limb_sums_to_pair(narrow_r))
        _same(D.limb_sums_to_pair(wide_p), R.limb_sums_to_pair(wide_r))
        assert D.narrow_sums_to_ints(narrow_p) == R.narrow_sums_to_ints(
            np.asarray(narrow_r)
        )
        assert D.wide_sums_to_ints(wide_p) == R.wide_sums_to_ints(np.asarray(wide_r))
    # the reconstruction is the exact sum of the selected values
    use = valid
    want = [0] * 7
    for g, x, y, u in zip(gids, a, b, use):
        if u:
            want[g] += R.pair_to_int(x, y)
    got = D.wide_sums_to_ints(D.wide_limb_sums(_t(a), _t(b), _t(use), port_seg))
    assert got == want


@pytest.mark.parametrize("shift", [0, 4, 38])
def test_div128_round(ab, shift):
    a, b = ab
    n = 512
    hi, lo = a[:n], b[:n]
    # divisors: zero, +-1, the edges as hi and lo, small and large values
    c = _lanes(7, n)
    d = _lanes(8, n)
    small = np.arange(n) % 4 == 0
    c = np.where(small, c >> 63, c >> np.int64(shift % 5))
    d[::17] = 0
    c[::17] = 0
    d[1::17] = 1
    c[1::17] = 0
    d[2::17] = -1
    c[2::17] = -1
    port = D.div128_round(_t(hi), _t(lo), _t(c), _t(d), shift)
    ref = R.div128_round(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c), jnp.asarray(d), shift
    )
    _same(port, ref)
    ok = port[2].numpy()
    assert ok.any() and not ok.all()


def test_rescale_up_wide(ab):
    a, b = ab
    hi, lo = a >> 40, b
    for digits in (0, 5, 18, 25):
        _same(
            D.rescale_up_wide(_t(hi), _t(lo), digits),
            R.rescale_up_wide(jnp.asarray(hi), jnp.asarray(lo), digits),
        )


@pytest.mark.parametrize("kind", ["min", "max"])
def test_global_minmax_wide(ab, kind):
    a, b = ab
    n = a.shape[0]
    rng = np.random.default_rng(9)
    hi = np.where(rng.random(n) < 0.5, a >> 62, a)  # many ties on hi
    for use in (rng.random(n) < 0.3, np.zeros(n, np.bool_)):
        _same(
            D.global_minmax_wide(_t(hi), _t(b), _t(use), kind),
            R.global_minmax_wide(
                jnp.asarray(hi), jnp.asarray(b), jnp.asarray(use), kind
            ),
        )


def test_wide_columns_through_batches(ab):
    """(n, 2) DECIMAL(38) data through take, concat_batches, pad_batch and
    to_pylist, against the reference's Batch on the same values."""
    from trino_tpu import types as RT
    from trino_tpu.columnar import Batch as RBatch, Column as RColumn
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column, concat_batches, pad_batch

    a, b = ab
    wide = np.stack([a[:64] >> 3, b[:64]], axis=1)
    valid = np.arange(64) % 5 != 0
    ref_rows = RBatch(
        [RColumn(RT.decimal(38, 4), wide, valid)], 64
    ).to_pylist()
    col = Column(T.decimal(38, 4), _t(wide), _t(valid))
    halves = [Batch([col], 64).take(torch.arange(0, 32)),
              Batch([col], 64).take(torch.arange(32, 64))]
    joined = concat_batches(halves)
    assert joined.columns[0].data.shape == (64, 2)
    padded = pad_batch(joined, 128)
    assert padded.columns[0].data.shape == (128, 2)
    rows = Batch(padded.columns, 64).to_pylist()
    assert rows == ref_rows
    assert any(r[0] is None for r in rows) and any(r[0] for r in rows)


@pytest.mark.parametrize("op", ["lt", "ge", "eq"])
def test_wide_literal_compares_like_reference(ab, op):
    """A DECIMAL literal past int64 evaluates to wide (n, 2) lanes and
    compares with wide values in both compilers (SQL text cannot carry one:
    the analyzer types literals at 18 digits or fewer)."""
    from trino_tpu import types as RT
    from trino_tpu import ir as RIR
    from trino_tpu.columnar import Column as RColumn
    from trino_tpu.compiler import ExprCompiler as RCompiler
    from trino_tpu_torch import ir as IR
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Column
    from trino_tpu_torch.compiler import ExprCompiler

    a, b = ab
    wide = np.stack([a >> 2, b], axis=1)
    value = R.pair_to_int(int(wide[600, 0]), int(wide[600, 1]))  # ties a row
    assert abs(value) >= 1 << 63

    def expr(mod, t):
        col = mod.InputRef(type=t.decimal(38, 1), channel=0)
        lit = mod.Constant(type=t.decimal(38, 1), value=value)
        return mod.Call(type=t.BOOLEAN, name=op, args=(col, lit)), lit

    rexpr, rlit = expr(RIR, RT)
    pexpr, plit = expr(IR, T)
    rcomp = RCompiler([RColumn(RT.decimal(38, 1), jnp.asarray(wide))])
    pcomp = ExprCompiler([Column(T.decimal(38, 1), _t(wide))], device="cpu")
    _same(pcomp.evaluate(plit), rcomp.evaluate(rlit))
    _same(pcomp.evaluate(pexpr), rcomp.evaluate(rexpr))
    got = pcomp.evaluate(pexpr)[0]
    assert got.any() and not got.all()
