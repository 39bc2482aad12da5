"""The distributed join step on a mesh of one device.

Counterpart of ``trino_tpu/parallel/distributed.py::_sharded_probe``. The
reference runs it under ``shard_map``: each shard builds a table from its
(replicated or co-partitioned) build side, probes its own rows and expands
the matches into a fixed capacity, and the overflow flags are reduced with
``pmax``. On one device the shard is the whole relation and ``pmax`` of a
flag is the flag itself, so the build is never sharded.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.ops import dense_join as DJ
from trino_tpu_torch.ops import join as J


def _pad_side(cols, keys, h, sel):
    """Kernels reject 0-row arrays: an empty relation becomes one
    unselected row."""
    if h.shape[0] > 0:
        return cols, keys, h, sel
    cols = [c.new_zeros((1,) + tuple(c.shape[1:])) for c in cols]
    keys = [k.new_zeros((1,) + tuple(k.shape[1:])) for k in keys]
    return cols, keys, h.new_zeros(1), sel.new_zeros(1)


def _sharded_probe(
    probe_cols,
    probe_keys,
    ph,
    probe_sel,
    build_cols,
    build_keys,
    bh,
    build_sel,
    per_shard_cap,
    join_type,
    nlk,
    strategy="sort",
    table_cap=None,
):
    """Build a table from the build side, probe the probe rows, expand into
    ``per_shard_cap`` output slots.

    ``probe_cols``/``build_cols`` are flat (data, valid) lists of the
    payload columns, ``probe_keys``/``build_keys`` flat (data, valid) lists
    of the ``nlk`` key columns. ``strategy`` picks the join kernel:
    ``sort`` (ops/join.py sorted build + binary-search probe), ``dense``
    (ops/dense_join.py open-addressing table of ``table_cap`` slots, built
    by kernel K2) or ``matmul`` (the same table addressed by identity
    binning of the single integer key column).

    Returns ``(out_cols, out_sel, overflow)``; non-sort strategies add a
    fourth element, the table-overflow flag whose ``densejoin`` capacity
    site the executor's retry ladder doubles.
    """
    probe_cols, probe_keys, ph, probe_sel = _pad_side(
        probe_cols, probe_keys, ph, probe_sel
    )
    build_cols, build_keys, bh, build_sel = _pad_side(
        build_cols, build_keys, bh, build_sel
    )
    # key validity: all key columns non-null
    pk_pairs = [(probe_keys[2 * k], probe_keys[2 * k + 1]) for k in range(nlk)]
    bk_pairs = [(build_keys[2 * k], build_keys[2 * k + 1]) for k in range(nlk)]
    pv = torch.ones_like(probe_sel)
    for _, kv in pk_pairs:
        pv = pv & kv
    bv = torch.ones_like(build_sel)
    for _, kv in bk_pairs:
        bv = bv & kv
    jt = "left" if join_type == "LEFT" else "inner"
    tovf = None
    if strategy == "sort":
        sbk, sbi, bcount = J.build_side(bh, bv, build_sel)
        ppos, bpos, osel, _, ovf = J.probe_join(
            sbk, sbi, bcount, ph, pv, probe_sel, per_shard_cap, jt,
        )
    else:
        if strategy == "matmul":
            # identity binning of the single key column (the caller gates
            # matmul on nlk == 1 and an integer key dtype)
            kmin = torch.where(
                bv & build_sel, bk_pairs[0][0].to(torch.int64), 2**63 - 1
            ).min()
            bbase = DJ.slot_base_binned(bk_pairs[0][0], kmin, table_cap)
            pbase = DJ.slot_base_binned(pk_pairs[0][0], kmin, table_cap)
        else:
            bbase = DJ.slot_base_hash(bh, table_cap)
            pbase = DJ.slot_base_hash(ph, table_cap)
        table, tovf = DJ.build_table(bbase, bv, build_sel, table_cap)
        ppos, bpos, osel, _, ovf = DJ.probe_table(
            table, bh, pbase, ph, pv, probe_sel, per_shard_cap, jt,
        )
    osel = J.verify_equal(pk_pairs, bk_pairs, ppos, bpos, osel)
    is_outer = bpos == J.MISSING
    pidx = ppos.long()
    bidx = torch.where(is_outer, 0, bpos).long()
    outs = []
    for k in range(0, len(probe_cols), 2):
        outs.append(probe_cols[k][pidx])
        outs.append(probe_cols[k + 1][pidx])
    for k in range(0, len(build_cols), 2):
        outs.append(build_cols[k][bidx])
        outs.append(build_cols[k + 1][bidx] & ~is_outer)
    if tovf is None:
        return outs, osel, ovf
    return outs, osel, ovf, tovf
