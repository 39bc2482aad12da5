"""The port's mesh, exchange and skew functions against the reference.

``trino_tpu_torch/parallel/mesh.py``, ``parallel/exchange.py`` and
``ops/skew.py`` run every shard of a mesh on one device; the reference
runs them under ``shard_map`` on the repo's 8-device virtual CPU mesh
(``tests/conftest.py``). The same inputs, made from a seed with numpy, go
through both at N = 8 and at N = 3 (``make_mesh(3)`` on both sides), and
every output (columns, masks, flags, counts) must be equal elementwise:
the tolerance is zero.

The sketch's inputs keep the k-th and (k+1)-th candidate counts apart on
every shard: on such a tie the reference's pick is unspecified (it sorts
on the count alone, unstably), the port's is by hash.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SHARDS = [8, 3]


@pytest.fixture(scope="module", params=SHARDS)
def meshes(request):
    import jax

    from trino_tpu.parallel.mesh import make_mesh as ref_mesh
    from trino_tpu_torch.parallel.mesh import make_mesh

    n = request.param
    if len(jax.devices()) < n:
        pytest.skip("needs the 8-device virtual mesh")
    return n, ref_mesh(n), make_mesh(n, "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _jit(fn, *args, **kw):
    """A reference function under ``jax.jit`` (the same computation; an
    eager ``shard_map`` dispatches op by op, ten times slower here)."""
    import jax

    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _eq(port, ref, what):
    p = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert (p == r).all(), (what, p, r)


def _skewed_input(n, m_per, seed):
    """Per shard ``m_per`` rows; hashes with three hot keys at distinct
    counts above a tail of unique hashes, some rows dead (the sketches
    keep k = 3 candidates a shard, so no tie reaches the k-th)."""
    rng = np.random.default_rng(seed)
    m = n * m_per
    khash = rng.integers(-(1 << 62), 1 << 62, m).astype(np.int64)
    pick = rng.random(m)
    khash[pick < 0.30] = 1000
    khash[(pick >= 0.30) & (pick < 0.45)] = -77
    khash[(pick >= 0.45) & (pick < 0.55)] = 5
    sel = rng.random(m) < 0.9
    cols = [
        rng.integers(-(1 << 40), 1 << 40, m).astype(np.int64),
        rng.random(m) < 0.8,
        rng.integers(-(1 << 30), 1 << 30, m).astype(np.int32),
        rng.standard_normal(m),
    ]
    return khash, sel, cols


def test_collectives_over_the_shard_view():
    """The collectives as operations on the [n, ...] view: all to all is a
    transpose of the [n_src, n_dst, B] blocks, all gather the
    concatenation, psum and pmax reductions over the shard axis."""
    from trino_tpu_torch.parallel import mesh as M

    x = torch.arange(3 * 3 * 2).reshape(3, 3, 2)
    out = M.all_to_all(x)
    for d in range(3):
        assert out[d].tolist() == torch.cat([x[s, d] for s in range(3)]).tolist()
    assert M.all_gather(x).tolist() == x.reshape(-1, 2).tolist()
    assert M.psum(x).tolist() == x.sum(0).tolist()
    assert M.pmax(x).tolist() == x.amax(0).tolist()
    with pytest.raises(NotImplementedError, match="9c"):
        M.Mesh(["cpu", "meta"])


def test_hash_repartition_and_needed_bucket(meshes):
    from trino_tpu.parallel import exchange as RX
    from trino_tpu_torch.parallel import exchange as X

    n, rmesh, mesh = meshes
    khash, sel, cols = _skewed_input(n, 96, seed=1)
    rb = RX.needed_bucket(rmesh, _j(khash), _j(sel))
    pb = X.needed_bucket(mesh, _t(khash), _t(sel))
    assert pb == rb
    for bucket in (rb, max(8, rb // 2)):  # fitting, then overflowing
        rout, rsel, rovf = _jit(lambda a, k, s: RX.hash_repartition(rmesh, a, k, s, bucket),
                                [_j(c) for c in cols], _j(khash), _j(sel))
        pout, psel, povf = X.hash_repartition(mesh, [_t(c) for c in cols], _t(khash),
                                              _t(sel), bucket)
        _eq(psel, rsel, "sel")
        _eq(povf, rovf, "overflow")
        for i, (p, r) in enumerate(zip(pout, rout)):
            _eq(p, r, f"col{i}")
    assert int(povf) == 1


@pytest.mark.parametrize("mode", ["plain", "detect", "replicate"])
def test_skewed_repartition(meshes, mode):
    """The two-tier exchange with no hot set, the probe side that detects
    its hot set (local), and the build side that replicates with it; a
    small spill tier overflows in the plain mode."""
    from trino_tpu.ops import skew as RSK
    from trino_tpu.parallel import exchange as RX
    from trino_tpu_torch.ops import skew as SK
    from trino_tpu_torch.parallel import exchange as X

    n, rmesh, mesh = meshes
    khash, sel, cols = _skewed_input(n, 128, seed=2 + n)
    wide = np.stack([cols[0], cols[0] >> 3], axis=1)  # a (N, 2) lane pair
    rcols = [_j(c) for c in cols] + [_j(wide)]
    pcols = [_t(c) for c in cols] + [_t(wide)]
    bucket, spill = 8, 16
    kw_r, kw_p = {}, {}
    if mode == "detect":
        kw_r = kw_p = {"hot_mode": "local", "hot_cap": 64, "detect": (3, 0.5)}
    elif mode == "replicate":
        hh, hv, _, _ = _jit(lambda k, s: RSK.hot_key_hashes(rmesh, k, s, 3, 0.5),
                            _j(khash), _j(sel))
        phh, phv, _, _ = SK.hot_key_hashes(mesh, _t(khash), _t(sel), 3, 0.5)
        _eq(phh, hh, "hot hashes")
        _eq(phv, hv, "hot valid")
        kw_r = {"hot_mode": "replicate", "hot_cap": 32, "hot_set": (hh, hv)}
        kw_p = {"hot_mode": "replicate", "hot_cap": 32, "hot_set": (phh, phv)}
    r = _jit(lambda a, k, s, *h: RX.skewed_repartition(
        rmesh, a, k, s, bucket, spill, **dict(kw_r, **({"hot_set": h} if h else {}))),
        rcols, _j(khash), _j(sel), *kw_r.get("hot_set", ()))
    p = X.skewed_repartition(mesh, pcols, _t(khash), _t(sel), bucket, spill, **kw_p)
    for i, (pc, rc) in enumerate(zip(p[0], r[0])):
        _eq(pc, rc, f"col{i}")
    _eq(p[1], r[1], "sel")
    for i in range(2):
        _eq(p[2][i], r[2][i], f"flag{i}")
    for i in range(3):
        _eq(p[3][i], r[3][i], f"counter{i}")
    assert len(p[4]) == len(r[4])
    for i, (pc, rc) in enumerate(zip(p[4], r[4])):
        _eq(pc, rc, f"hotset{i}")
    if mode == "plain":
        assert int(p[2][0]) == 1  # the spill tier overflowed
    else:
        assert int(p[3][2]) >= 1 and int(p[3][1]) > 0


def test_sketch_split_counts_and_broadcast(meshes):
    from trino_tpu.ops import skew as RSK
    from trino_tpu.parallel import exchange as RX
    from trino_tpu_torch.ops import skew as SK
    from trino_tpu_torch.parallel import exchange as X

    n, rmesh, mesh = meshes
    khash, sel, cols = _skewed_input(n, 64, seed=20 + n)
    r = _jit(lambda k, s: RSK.hot_key_hashes(rmesh, k, s, 3, 0.5), _j(khash), _j(sel))
    p = SK.hot_key_hashes(mesh, _t(khash), _t(sel), 3, 0.5)
    for i, what in enumerate(("hashes", "valid", "n_hot", "total")):
        _eq(p[i], r[i], what)
    assert int(p[2]) >= 1
    _eq(SK.is_hot(p[0], p[1], _t(khash)), RSK.is_hot(r[0], r[1], _j(khash)), "is_hot")
    assert X.skew_split_counts(mesh, _t(khash), _t(sel), p[0], p[1]) == \
        RX.skew_split_counts(rmesh, _j(khash), _j(sel), r[0], r[1])
    # a source whose rows do not divide by the mesh pads up
    m = n * 5 + 1
    rout, rsel = _jit(lambda a, s: RX.broadcast_all(rmesh, a, s), [_j(cols[0][:m])],
                      _j(sel[:m]))
    pout, psel = X.broadcast_all(mesh, [_t(cols[0][:m])], _t(sel[:m]))
    _eq(pout[0], rout[0], "broadcast col")
    _eq(psel, rsel, "broadcast sel")


def test_sketch_dead_rows_and_uniform(meshes):
    """The reference's sketch cases: dead rows never count, a uniform key
    set has no hot key."""
    from trino_tpu_torch.ops import skew as SK

    n, _, mesh = meshes
    m = 128 * n
    khash = torch.full((m,), 77, dtype=torch.int64)
    sel = torch.zeros(m, dtype=torch.bool)
    sel[:4] = True
    _, _, n_hot, total = SK.hot_key_hashes(mesh, khash, sel, 8, 0.5)
    assert int(total) == 4 and int(n_hot) == 1
    uniform = torch.from_numpy(np.random.default_rng(12).permutation(np.arange(1, m + 1)))
    _, _, n_hot, _ = SK.hot_key_hashes(mesh, uniform, torch.ones(m, dtype=torch.bool), 8, 0.5)
    assert int(n_hot) == 0


def test_shard_batch_pads_masks_and_unifies_dictionaries(meshes):
    """``prepare_shards``/``shard_batch`` with parts of unequal sizes, a
    selection on one part, NULLs and per-part string dictionaries: the
    global columns, masks and merged dictionary equal the reference's."""
    from trino_tpu import types as RT
    from trino_tpu.columnar import Batch as RBatch, Column as RColumn, Dictionary as RDict
    from trino_tpu.parallel.mesh import shard_batch as ref_shard_batch
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column, Dictionary
    from trino_tpu_torch.parallel.mesh import shard_batch

    n, rmesh, mesh = meshes
    rng = np.random.default_rng(5)
    rparts, pparts = [], []
    words = ["a", "bb", "c", "dd", "e", "ff"]
    for s in range(n):
        m = int(rng.integers(1, 9))
        vals = rng.integers(0, 1000, m).astype(np.int64)
        valid = rng.random(m) < 0.8
        vocab = list(rng.choice(words, size=3, replace=False))
        codes = rng.integers(0, 3, m).astype(np.int32)
        sel = (rng.random(m) < 0.7) if s == 1 else None
        rparts.append(RBatch(
            [RColumn(RT.BIGINT, vals, valid), RColumn(RT.VARCHAR, codes, None, RDict(vocab))],
            m, sel))
        pparts.append(Batch(
            [Column(T.BIGINT, _t(vals), _t(valid)),
             Column(T.VARCHAR, _t(codes), None, Dictionary(vocab))],
            m, None if sel is None else _t(sel), torch.device("cpu")))
    rb = ref_shard_batch(rmesh, rparts)
    pb = shard_batch(mesh, pparts)
    assert pb.shards == n and pb.capacity == rb.capacity
    _eq(pb.selection_mask(), rb.selection_mask(), "sel")
    for pc, rc in zip(pb.columns, rb.columns):
        _eq(pc.data, rc.data, "data")
        _eq(pc.valid_mask(), rc.valid_mask(), "valid")
    assert list(pb.columns[1].dictionary.values) == list(rb.columns[1].dictionary.values)
