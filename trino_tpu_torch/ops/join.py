"""Equi-join kernels of the sort tier: sorted build side, binary-search probe.

Reference: Trino's hash join — ``operator/HashBuilderOperator.java:51``,
``operator/PagesHash.java:34``, ``operator/LookupJoinOperator.java:71``.
Counterpart of ``trino_tpu/ops/join.py`` with the same contracts:

1. Each side's key columns hash into one int64 (``mix64`` per column,
   combined); NULL keys never match.
2. The build side sorts by hash, ties in row order.
3. The probe finds its match range with two binary searches and expands
   the matches into a fixed output capacity: per output slot, the probe row
   that owns it (``searchsorted`` over the running match ends) and the
   build row it pairs with.
4. Hashes may collide, so :func:`verify_equal` re-checks the real keys
   after the expansion.

There is no uint64 in torch on every device, so 64-bit unsigned math is
int64 with masked logical shifts (``x >>> k`` is
``(x >> k) & (2^(64-k) - 1)``) and wrapping multiplies: the bits equal the
reference's uint64 ones.
"""

from __future__ import annotations

import torch

MISSING = 2**31 - 1  # build position marking "no match" (left join)
_INT64_MAX = 2**63 - 1


def _u64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _u64(0xBF58476D1CE4E5B9)
_M2 = _u64(0x94D049BB133111EB)


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bits (same bits as the reference's
    uint64 version)."""
    x = x.to(torch.int64)
    x = (x ^ _lsr(x, 30)) * _M1
    x = (x ^ _lsr(x, 27)) * _M2
    return x ^ _lsr(x, 31)


def hash_keys(keys):
    """Combine key columns [(data, valid), ...] into (hash int64, all_valid)."""
    acc = torch.zeros(keys[0][0].shape[0], dtype=torch.int64,
                      device=keys[0][0].device)
    all_valid = None
    for data, valid in keys:
        acc = mix64(acc ^ mix64(data))
        all_valid = valid if all_valid is None else (all_valid & valid)
    return acc, all_valid


def build_side(key_hash: torch.Tensor, valid: torch.Tensor, sel: torch.Tensor):
    """Sort build rows by hashed key; invalid/unselected rows go last.

    Returns (sorted_keys, sorted_row_indices int32, build_count). A stable
    sort of the keys gives the reference's order by (key, row index)."""
    use = valid & sel
    keyed = torch.where(use, key_hash, _INT64_MAX)
    sorted_keys, order = torch.sort(keyed, stable=True)
    return sorted_keys, order.to(torch.int32), use.sum().to(torch.int32)


def _empty_result(out_capacity: int, device):
    return (
        torch.zeros(out_capacity, dtype=torch.int32, device=device),
        torch.full((out_capacity,), MISSING, dtype=torch.int32, device=device),
        torch.zeros(out_capacity, dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int64, device=device),
        torch.zeros((), dtype=torch.bool, device=device),
    )


def expand_matches(counts, probe_sel, out_capacity: int, join_type: str):
    """Fixed-capacity expansion shared by both join tiers: per output slot
    ``t``, the probe row that owns it and the rank ``j`` of the slot among
    that row's matches. LEFT joins emit one slot for an unmatched selected
    probe row. Returns (probe_pos int32, j, out_sel, total, overflow)."""
    if join_type == "left":
        emit = torch.where(probe_sel, torch.clamp(counts, min=1), 0)
    elif join_type == "inner":
        emit = counts
    else:
        raise NotImplementedError(join_type)
    emit = emit.to(torch.int64)
    ends = torch.cumsum(emit, 0)  # inclusive end per probe row
    offsets = ends - emit
    total = ends[-1]
    t = torch.arange(out_capacity, dtype=torch.int64, device=emit.device)
    probe_pos = torch.searchsorted(ends, t, right=True)
    probe_pos = torch.clamp(probe_pos, max=emit.shape[0] - 1)
    j = t - offsets[probe_pos]
    return probe_pos.to(torch.int32), j, t < total, total, total > out_capacity


def probe_join(
    sorted_build_keys: torch.Tensor,
    sorted_build_idx: torch.Tensor,
    build_count: torch.Tensor,
    probe_hash: torch.Tensor,
    probe_valid: torch.Tensor,
    probe_sel: torch.Tensor,
    out_capacity: int,
    join_type: str = "inner",
):
    """Expand probe x build matches into fixed-capacity gather indices.

    Returns (probe_pos, build_pos, out_sel, total, overflow):
      probe_pos/build_pos: (out_capacity,) int32 gather indices into the
        original (unsorted) batches; build_pos == MISSING for outer rows.
      out_sel: (out_capacity,) bool — which output slots are live.
      total: int64 scalar — true number of output rows.
      overflow: bool scalar — total > out_capacity.
    """
    dev = probe_hash.device
    use = probe_valid & probe_sel
    if probe_hash.shape[0] == 0:
        return _empty_result(out_capacity, dev)  # statically empty probe
    if sorted_build_idx.shape[0] == 0:
        # statically empty build: no matches; LEFT still emits probe rows
        if join_type != "left":
            return _empty_result(out_capacity, dev)
        zero = torch.zeros_like(probe_hash)
        ppos, _, osel, total, ovf = expand_matches(
            zero, probe_sel, out_capacity, "left"
        )
        bpos = torch.full((out_capacity,), MISSING, dtype=torch.int32, device=dev)
        return ppos, bpos, osel, total, ovf
    keys = torch.where(use, probe_hash, _INT64_MAX - 1)  # never matches maxv
    lo = torch.searchsorted(sorted_build_keys, keys, right=False)
    hi = torch.searchsorted(sorted_build_keys, keys, right=True)
    hi = torch.minimum(hi, build_count.to(hi.dtype))
    lo = torch.minimum(lo, hi)
    counts = torch.where(use, hi - lo, 0)
    probe_pos, j, out_sel, total, overflow = expand_matches(
        counts, probe_sel, out_capacity, join_type
    )
    ppos = probe_pos.long()
    build_slot = torch.clamp(lo[ppos] + j, 0, sorted_build_idx.shape[0] - 1)
    build_pos = torch.where(
        counts[ppos] > 0, sorted_build_idx[build_slot], MISSING
    ).to(torch.int32)
    return probe_pos, build_pos, out_sel, total, overflow


def verify_equal(probe_keys, build_keys, probe_pos, build_pos, out_sel):
    """Exactness pass: re-check real key equality after hash-based expansion.

    probe_keys/build_keys: [(data, valid), ...] original (unsorted) columns.
    Rows where build_pos == MISSING (left-outer padding) are kept.
    """
    is_outer = build_pos == MISSING
    ppos = probe_pos.long()
    safe_build = torch.where(is_outer, 0, build_pos).long()
    ok = torch.ones_like(out_sel)
    for (pd, pv), (bd, bv) in zip(probe_keys, build_keys):
        if pd.shape[0] == 0 or bd.shape[0] == 0:
            return out_sel & is_outer  # statically empty side
        ok = ok & (pd[ppos] == bd[safe_build]) & pv[ppos] & bv[safe_build]
    return out_sel & (ok | is_outer)


def semi_join_mask(sorted_build_keys, build_count, probe_hash, probe_valid):
    """EXISTS-style membership at the hash level: does the probe key's hash
    appear among the build's live hashes?"""
    keys = torch.where(probe_valid, probe_hash, _INT64_MAX - 1)
    lo = torch.searchsorted(sorted_build_keys, keys, right=False)
    hi = torch.searchsorted(sorted_build_keys, keys, right=True)
    hi = torch.minimum(hi, build_count.to(hi.dtype))
    return (hi > lo) & probe_valid
