"""The distributed join step on a mesh of one device.

Counterpart of ``trino_tpu/parallel/distributed.py::_sharded_probe``. The
reference runs it under ``shard_map``: each shard builds a table from its
(replicated or co-partitioned) build side, probes its own rows and expands
the matches into a fixed capacity, and the overflow flags are reduced with
``pmax``. On one device the shard is the whole relation and ``pmax`` of a
flag is the flag itself, so the build is never sharded.

The step is two functions, :func:`build_join` and :func:`probe_build`, so
that a streamed fragment builds each join's table once and probes it
with every chunk (``exec/streaming.py``); a materialized join calls one
after the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


@dataclasses.dataclass
class JoinBuild:
    """A join's build side, made once and probed by any number of probe
    batches (reference: ``HashBuilderOperator``/``LookupJoinOperator``,
    build once and probe streamed): the padded build payload and key
    columns, their hash and liveness, and the strategy's structure, the
    hash-sorted build for ``sort`` or the open-addressing table (kernel
    K2) for ``dense`` and ``matmul``."""

    cols: list
    key_pairs: list
    bh: torch.Tensor
    strategy: str
    sorted_keys: Optional[torch.Tensor] = None
    sorted_idx: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None
    table_overflow: Optional[torch.Tensor] = None
    kmin: Optional[torch.Tensor] = None


def build_join(build_cols, build_keys, bh, build_sel, nlk, strategy="sort",
               table_cap=None) -> JoinBuild:
    """The build step: ``build_cols`` and ``build_keys`` are flat
    (data, valid) lists of the payload and of the ``nlk`` key columns,
    ``bh`` the keys' hash. ``strategy`` picks the join kernel: ``sort``
    (ops/join.py: the live rows sorted by hash, probed by binary search),
    ``dense`` (ops/dense_join.py: an open-addressing table of
    ``table_cap`` slots, built by kernel K2) or ``matmul`` (the same
    table addressed by identity binning of the single integer key
    column; the caller gates it on ``nlk == 1`` and an integer key
    dtype)."""
    build_cols, build_keys, bh, build_sel = _pad_side(build_cols, build_keys, bh, build_sel)
    key_pairs = [(build_keys[2 * k], build_keys[2 * k + 1]) for k in range(nlk)]
    bv = torch.ones_like(build_sel)
    for _, kv in key_pairs:
        bv = bv & kv
    out = JoinBuild(build_cols, key_pairs, bh, strategy)
    if strategy == "sort":
        out.sorted_keys, out.sorted_idx, out.count = J.build_side(bh, bv, build_sel)
        return out
    if strategy == "matmul":
        out.kmin = torch.where(
            bv & build_sel, key_pairs[0][0].to(torch.int64), 2**63 - 1
        ).min()
        bbase = DJ.slot_base_binned(key_pairs[0][0], out.kmin, table_cap)
    else:
        bbase = DJ.slot_base_hash(bh, table_cap)
    out.table, out.table_overflow = DJ.build_table(bbase, bv, build_sel, table_cap)
    return out


def probe_build(build: JoinBuild, probe_cols, probe_keys, ph, probe_sel,
               per_shard_cap, join_type):
    """The probe step: probe rows against a :class:`JoinBuild`, their
    matches expanded into ``per_shard_cap`` output slots (None: sized to
    the matches, one host read; ``out_sel.shape[0]`` is then the capacity
    chosen), the real keys re-checked and the payloads gathered.
    ``probe_cols``/``probe_keys`` are flat (data, valid) lists like the
    build's.

    Returns ``(out_cols, out_sel, overflow, table_overflow, total)``:
    ``out_cols`` the probe payload then the build payload, flat (data,
    valid); ``table_overflow`` the build's flag, whose ``densejoin``
    capacity site the executor's retry ladder doubles (None for the sort
    strategy); ``total`` the count of matches the output needed, so an
    overflowed output grows to fit them at once."""
    probe_cols, probe_keys, ph, probe_sel = _pad_side(probe_cols, probe_keys, ph, probe_sel)
    pk_pairs = [(probe_keys[2 * k], probe_keys[2 * k + 1])
                for k in range(len(build.key_pairs))]
    pv = torch.ones_like(probe_sel)
    for _, kv in pk_pairs:
        pv = pv & kv
    jt = "left" if join_type == "LEFT" else "inner"
    if build.strategy == "sort":
        ppos, bpos, osel, total, ovf = J.probe_join(
            build.sorted_keys, build.sorted_idx, build.count, ph, pv, probe_sel,
            per_shard_cap, jt,
        )
    else:
        cap = build.table.shape[0]
        if build.strategy == "matmul":
            pbase = DJ.slot_base_binned(pk_pairs[0][0], build.kmin, cap)
        else:
            pbase = DJ.slot_base_hash(ph, cap)
        ppos, bpos, osel, total, ovf = DJ.probe_table(
            build.table, build.bh, pbase, ph, pv, probe_sel, per_shard_cap, jt,
        )
    osel = J.verify_equal(pk_pairs, build.key_pairs, ppos, bpos, osel)
    is_outer = bpos == J.MISSING
    pidx = ppos.long()
    bidx = torch.where(is_outer, 0, bpos).long()
    outs = []
    for k in range(0, len(probe_cols), 2):
        outs.append(probe_cols[k][pidx])
        outs.append(probe_cols[k + 1][pidx])
    for k in range(0, len(build.cols), 2):
        outs.append(build.cols[k][bidx])
        outs.append(build.cols[k + 1][bidx] & ~is_outer)
    return outs, osel, ovf, build.table_overflow, total
