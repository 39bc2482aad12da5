"""The join kernels of trino_tpu_torch against the JAX reference, on the CPU.

The same numpy inputs go through ``trino_tpu.ops.join`` /
``trino_tpu.ops.dense_join`` and their ports in ``trino_tpu_torch.ops``.
Everything compared is an integer, a hash or a flag: the tolerance is
zero, and hashes must be equal bit for bit because the dense table's slot
bases are their low bits.

K2, the dense build, is compared two ways. The port's round build
(``build_table_plain``, which the CUDA kernel equals elementwise on the
card) must equal the reference's round build ``build_table`` elementwise.
The reference's Pallas kernel ``build_table_device`` inserts rows one at a
time and may lay out colliding keys differently (bases 5, 5, 6 with W=2:
the sequential build places all three rows, the rounds do not), so against
it the comparison is the join that probing the table gives, on inputs
where both place every row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.exec.fragments import _Caps as RCaps
from trino_tpu.ops import dense_join as RDJ
from trino_tpu.ops import join as RJ
from trino_tpu.ops.sort import SortKey as RSortKey, sort_indices as r_sort_indices
from trino_tpu_torch import _kernels
from trino_tpu_torch.exec.fragments import _Caps
from trino_tpu_torch.ops import dense_join as DJ
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.sort import SortKey, sort_indices


def both(data, valid=None):
    """One key column as ([(jnp data, jnp valid)], [(torch data, torch valid)])."""
    data = np.asarray(data, np.int64)
    valid = np.ones(len(data), bool) if valid is None else np.asarray(valid, bool)
    return (
        [(jnp.asarray(data), jnp.asarray(valid))],
        [(torch.from_numpy(data), torch.from_numpy(valid))],
    )


def same(a, b) -> bool:
    return np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize(
    "data",
    [np.array([0, 1, -1, 2**63 - 1, -(2**63), 12345, -987654321]),
     np.arange(-(2**31), 2**31, 2**27 + 11)],
    ids=["int64-extremes", "int32-range"],
)
def test_mix64_and_hash_keys_are_bit_equal(data):
    assert same(RJ.mix64(jnp.asarray(data)).astype(jnp.int64),
                J.mix64(torch.from_numpy(data)))
    r, t = both(data)
    (rh, _), (th, _) = RJ.hash_keys(r), J.hash_keys(t)
    assert same(rh, th)


def test_multi_key_hash_with_nulls_is_bit_equal():
    rng = np.random.default_rng(0)
    n = 500
    r1, t1 = both(rng.integers(-(2**40), 2**40, n), rng.random(n) < 0.8)
    r2, t2 = both(rng.integers(-5, 5, n).astype(np.int32), rng.random(n) < 0.9)
    rh, rv = RJ.hash_keys(r1 + r2)
    th, tv = J.hash_keys(t1 + t2)
    assert same(rh, th) and same(rv, tv)


def sides(seed, n_build=300, n_probe=200, domain=120):
    rng = np.random.default_rng(seed)
    bk = both(rng.integers(-domain, domain, n_build), rng.random(n_build) < 0.9)
    pk = both(rng.integers(-domain, domain, n_probe), rng.random(n_probe) < 0.9)
    bsel = rng.random(n_build) < 0.85
    psel = rng.random(n_probe) < 0.85
    return bk, pk, bsel, psel


@pytest.mark.parametrize("jt", ["inner", "left"])
@pytest.mark.parametrize("empty", [None, "build", "probe"])
def test_sort_tier_matches_reference(jt, empty):
    (rbk, tbk), (rpk, tpk), bsel, psel = sides(1)
    if empty == "build":
        (rbk, tbk), bsel = both([]), np.zeros(0, bool)
    if empty == "probe":
        (rpk, tpk), psel = both([]), np.zeros(0, bool)
    rbh, rbv = RJ.hash_keys(rbk) if len(bsel) else (jnp.zeros(0, jnp.int64), jnp.zeros(0, bool))
    tbh, tbv = J.hash_keys(tbk) if len(bsel) else (torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool))
    rph, rpv = RJ.hash_keys(rpk) if len(psel) else (jnp.zeros(0, jnp.int64), jnp.zeros(0, bool))
    tph, tpv = J.hash_keys(tpk) if len(psel) else (torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool))
    rs = RJ.build_side(rbh, rbv, jnp.asarray(bsel))
    ts = J.build_side(tbh, tbv, torch.from_numpy(bsel))
    for a, b in zip(rs, ts):
        assert same(a, b)
    rout = RJ.probe_join(*rs, rph, rpv, jnp.asarray(psel), 1024, jt)
    tout = J.probe_join(*ts, tph, tpv, torch.from_numpy(psel), 1024, jt)
    for a, b in zip(rout, tout):
        assert same(a, b)
    rsel = RJ.verify_equal(rpk, rbk, rout[0], rout[1], rout[2])
    tsel = J.verify_equal(tpk, tbk, tout[0], tout[1], tout[2])
    assert same(rsel, tsel)
    if empty is None:
        assert int(tsel.sum()) > 100


def test_sort_tier_output_overflow_matches_reference():
    (rbk, tbk), (rpk, tpk), bsel, psel = sides(2, domain=10)
    rs = RJ.build_side(*RJ.hash_keys(rbk), jnp.asarray(bsel))
    ts = J.build_side(*J.hash_keys(tbk), torch.from_numpy(bsel))
    rout = RJ.probe_join(*rs, *RJ.hash_keys(rpk), jnp.asarray(psel), 256, "inner")
    tout = J.probe_join(*ts, *J.hash_keys(tpk), torch.from_numpy(psel), 256, "inner")
    assert bool(tout[4]) and int(tout[3]) > 256
    for a, b in zip(rout, tout):
        assert same(a, b)


def test_semi_join_mask_matches_reference():
    (rbk, tbk), (rpk, tpk), bsel, _ = sides(3)
    rs = RJ.build_side(*RJ.hash_keys(rbk), jnp.asarray(bsel))
    ts = J.build_side(*J.hash_keys(tbk), torch.from_numpy(bsel))
    rph, rpv = RJ.hash_keys(rpk)
    tph, tpv = J.hash_keys(tpk)
    assert same(RJ.semi_join_mask(rs[0], rs[2], rph, rpv),
                J.semi_join_mask(ts[0], ts[2], tph, tpv))


@pytest.mark.parametrize("cap", [64, 1024])
def test_slot_bases_match_reference(cap):
    rng = np.random.default_rng(4)
    r, t = both(rng.integers(-(2**50), 2**50, 1000))
    assert same(RDJ.slot_base_hash(RJ.hash_keys(r)[0], cap),
                DJ.slot_base_hash(J.hash_keys(t)[0], cap))
    k = rng.integers(-500, 500, 1000)
    assert same(RDJ.slot_base_binned(jnp.asarray(k), jnp.int64(-37), cap),
                DJ.slot_base_binned(torch.from_numpy(k), -37, cap))


# (rows, key domain, capacity, window): plain, duplicate chains past the
# window, a window wider than the table, a table too small for the rows
BUILD_CASES = [(300, 1 << 40, 1024, 16), (300, 20, 1024, 16),
               (40, 1 << 40, 8, 16), (300, 1 << 40, 128, 16)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,domain,cap,window", BUILD_CASES,
                         ids=["plain", "dup-chains", "window>cap", "overflow"])
def test_round_build_equals_reference_elementwise(seed, n, domain, cap, window):
    rng = np.random.default_rng(seed)
    r, t = both(rng.integers(0, domain, n), rng.random(n) < 0.9)
    sel = rng.random(n) < 0.9
    rbase = RDJ.slot_base_hash(RJ.hash_keys(r)[0], cap)
    tbase = DJ.slot_base_hash(J.hash_keys(t)[0], cap)
    rtab, rovf = RDJ.build_table(rbase, r[0][1], jnp.asarray(sel), cap, window)
    before = _kernels.PLAIN_CALLS["dense_join_build"]
    ttab, tovf = DJ.build_table(tbase, t[0][1], torch.from_numpy(sel), cap, window)
    assert _kernels.PLAIN_CALLS["dense_join_build"] == before + 1
    assert same(rtab, ttab)
    assert bool(rovf) == bool(tovf)
    # K2's own contract: the count of unplaced live rows
    ptab, unplaced = DJ.build_table_plain(tbase, t[0][1] & torch.from_numpy(sel), cap, window)
    assert torch.equal(ptab, ttab) and bool(unplaced > 0) == bool(tovf)
    if (domain, cap) == (20, 1024) or cap == 8:
        assert bool(tovf)


def dense_join(keys_p, keys_b, psel, bsel, cap, out_cap, jt, build="plain"):
    """The dense tier end to end in one package: build, probe, verify.
    Returns the five probe outputs with the verified selection last."""
    if build == "reference-pallas":
        ph, pv = RJ.hash_keys(keys_p)
        bh, bv = RJ.hash_keys(keys_b)
        table, unplaced = RDJ.build_table_device(
            RDJ.slot_base_hash(bh, cap), bv & jnp.asarray(bsel), cap,
            interpret=True,
        )
        assert int(unplaced) == 0
        out = RDJ.probe_table(table, bh, RDJ.slot_base_hash(ph, cap), ph, pv,
                              jnp.asarray(psel), out_cap, jt)
        osel = RJ.verify_equal(keys_p, keys_b, out[0], out[1], out[2])
        return [np.asarray(x) for x in out] + [np.asarray(osel)]
    if build == "reference":
        ph, pv = RJ.hash_keys(keys_p)
        bh, bv = RJ.hash_keys(keys_b)
        table, ovf = RDJ.build_table(RDJ.slot_base_hash(bh, cap), bv,
                                     jnp.asarray(bsel), cap)
        out = RDJ.probe_table(table, bh, RDJ.slot_base_hash(ph, cap), ph, pv,
                              jnp.asarray(psel), out_cap, jt)
        osel = RJ.verify_equal(keys_p, keys_b, out[0], out[1], out[2])
        return [np.asarray(x) for x in out] + [np.asarray(osel)]
    ph, pv = J.hash_keys(keys_p)
    bh, bv = J.hash_keys(keys_b)
    table, ovf = DJ.build_table(DJ.slot_base_hash(bh, cap), bv,
                                torch.from_numpy(bsel), cap)
    assert not bool(ovf)
    out = DJ.probe_table(table, bh, DJ.slot_base_hash(ph, cap), ph, pv,
                         torch.from_numpy(psel), out_cap, jt)
    osel = J.verify_equal(keys_p, keys_b, out[0], out[1], out[2])
    return [x.numpy() for x in out] + [osel.numpy()]


@pytest.mark.parametrize("jt", ["inner", "left"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_table_matches_reference_elementwise(seed, jt):
    (rbk, tbk), (rpk, tpk), bsel, psel = sides(seed, domain=400)
    want = dense_join(rpk, rbk, psel, bsel, 2048, 1024, jt, "reference")
    got = dense_join(tpk, tbk, psel, bsel, 2048, 1024, jt)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert got[-1].sum() > 30


def test_port_build_joins_like_the_reference_pallas_kernel():
    """Where both builds place every row, probing the port's round table
    gives the join of the reference's sequential Pallas table elementwise."""
    rng = np.random.default_rng(11)
    n = 512
    bk = both(rng.integers(0, 200, n))  # heavy duplicate chains
    pk = both(rng.integers(0, 200, 300))
    psel, bsel = np.ones(300, bool), rng.random(n) < 0.9
    want = dense_join(pk[0], bk[0], psel, bsel, 4096, 4096, "inner",
                      "reference-pallas")
    got = dense_join(pk[1], bk[1], psel, bsel, 4096, 4096, "inner")
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_duplicate_keys_emit_in_ascending_build_order():
    bk = both([5, 7, 5, 5, 7])
    pk = both([5, 7])
    got = dense_join(pk[1], bk[1], np.ones(2, bool), np.ones(5, bool), 64, 16,
                     "inner")
    ppos, bpos, osel = got[0], got[1], got[-1]
    assert list(zip(ppos[osel].tolist(), bpos[osel].tolist())) == [
        (0, 0), (0, 2), (0, 3), (1, 1), (1, 4)
    ]


def test_sort_indices_match_reference():
    rng = np.random.default_rng(6)
    n = 400
    a = rng.integers(-3, 3, n)
    b = rng.integers(-(2**40), 2**40, n)
    av, bv = rng.random(n) < 0.9, rng.random(n) < 0.8
    sel = rng.random(n) < 0.9
    for ka, kb in [((True, False), (False, True)), ((False, True), (True, False))]:
        want = r_sort_indices(
            [(jnp.asarray(a), jnp.asarray(av)), (jnp.asarray(b), jnp.asarray(bv))],
            [RSortKey(*ka), RSortKey(*kb)], jnp.asarray(sel),
        )
        got = sort_indices(
            [(torch.from_numpy(a), torch.from_numpy(av)),
             (torch.from_numpy(b), torch.from_numpy(bv))],
            [SortKey(*ka), SortKey(*kb)], torch.from_numpy(sel),
        )
        assert same(want, got)


@pytest.mark.parametrize("caps_cls", [RCaps, _Caps], ids=["reference", "port"])
def test_caps_growth_and_demotion(caps_cls):
    caps = caps_cls()
    caps.get("densejoin@4#0", 64)
    caps.get("join@4#0", 1024)
    sig0 = caps.signature()
    caps.grow("densejoin@4#0")
    assert "densejoin@4#0" not in caps.demoted
    caps.grow("densejoin@4#0")
    assert "densejoin@4#0" in caps.demoted
    # the demotion is part of the signature: the same capacities with a
    # demoted site run a different join kernel
    assert caps.signature() != sig0
    assert caps.vals["densejoin@4#0"] == 256
    assert caps.provenance["densejoin@4#0"] == "default+grown"
    for _ in range(3):
        caps.grow("join@4#0")
    assert caps.demoted == {"densejoin@4#0"}
    assert caps.vals["join@4#0"] == 8192
    assert caps.seeded("densejoin@9#0") is None
    caps.seed("densejoin@9#0", 2048, floor_only=True, provenance="history")
    assert caps.seeded("densejoin@9#0") == (2048, "history")
    assert caps.get("densejoin@9#0", 1024) == 2048
