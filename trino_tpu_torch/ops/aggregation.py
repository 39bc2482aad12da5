"""Group-by aggregation: sort into groups, reduce per group.

Reference semantics: ``operator/HashAggregationOperator.java:49`` and the
aggregation function triple input/combine/output
(``operator/aggregation/LongSumAggregation.java:29-55``).

Counterpart of ``trino_tpu/ops/aggregation.py`` with the same contract
(outputs, capacity, overflow flag). Rows are sorted into groups; integer
sums are prefix-sum differences at the group boundaries, as in the
reference, so no row contends for a shared address; float sums and
min/max scatter by group id (``index_add_``, ``scatter_reduce_``).

Partial/final split: the same function serves both; COUNT partials
re-aggregate with SUM, AVG decomposes into SUM+COUNT (Trino's
input/combine/output contract for distributed aggregation). Exact
DECIMAL(38) sums accumulate 32-bit limbs (``sum128`` over int64 values,
``sum128w`` over (n, 2) wide values; ``ops/decimal128.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

AGG_KINDS = ("sum", "count", "count_star", "min", "max", "avg")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: kind + input channel (None for count(*))."""

    kind: str
    input_dtype: object | None = None  # storage dtype of the input


def group_aggregate(
    keys: Sequence[tuple[torch.Tensor, torch.Tensor | None]],
    sel: torch.Tensor,
    agg_inputs: Sequence[tuple[torch.Tensor, torch.Tensor | None] | None],
    agg_specs: Sequence[AggSpec],
    max_groups: int,
):
    """Grouped aggregation.

    Args:
      keys: per key column (data, valid-or-None), each shape (n,) or
        (n, 2) for a wide DECIMAL.
      sel: bool (n,) — rows participating.
      agg_inputs: per agg (data, valid-or-None) or None for count(*).
      agg_specs: kinds aligned with agg_inputs.
      max_groups: output capacity (groups beyond are dropped and the
        overflow flag is set).

    Returns:
      (group_key_data, group_key_valid): lists of (max_groups,) tensors
      agg_results: count kinds give counts; ``sum128``/``sum128w`` give
        (limb sums (max_groups, 3|5), count); the others (value, count),
        a wide min/max value being (max_groups, 2)
      num_groups: int64 scalar tensor
      overflow: bool scalar tensor
    """
    from trino_tpu_torch.ops import keypack as KP

    n = sel.shape[0]
    dev = sel.device
    s_lanes, perm, s_sel = KP.grouping_sort(keys, sel)
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        changed[0] = True
    for lane in s_lanes:
        changed[1:] |= lane[1:] != lane[:-1]
    changed &= s_sel
    num_groups = changed.sum()
    overflow = num_groups > max_groups
    seg = _SortedSegments(changed, s_sel, max_groups)

    out_key_data, out_key_valid = [], []
    for data, valid in keys:
        if n:
            g = data[perm[seg.first_idx]]
        else:
            g = data.new_zeros((max_groups,) + tuple(data.shape[1:]))
        kv = seg.nonempty
        if valid is not None and n:
            kv = valid[perm[seg.first_idx]] & kv
        mask = kv[:, None] if g.ndim == 2 else kv
        out_key_data.append(torch.where(mask, g, torch.zeros_like(g)))
        out_key_valid.append(kv)

    # aggregate inputs in sorted row order, gathered once per input, as
    # 1-D lanes (an (n, k) input gives k lanes)
    gathered: dict[tuple[int, int], tuple] = {}

    def sorted_pair(pair):
        pid = (id(pair[0]), id(pair[1]))
        if pid not in gathered:
            data, valid = pair
            s_valid = None if valid is None else valid[perm]
            gathered[pid] = (_lanes_at(data, perm), s_valid)
        return gathered[pid]

    results = []
    for spec, pair in zip(agg_specs, agg_inputs):
        if spec.kind == "count_star":
            results.append(seg.sizes)
            continue
        cols, s_valid = sorted_pair(pair)
        use = s_sel if s_valid is None else (s_sel & s_valid)
        cnt = seg.sizes if s_valid is None else seg.sum([use.to(torch.int64)])[:, 0]
        if spec.kind in ("sum128", "sum128w"):
            from trino_tpu_torch.ops import decimal128 as D

            if spec.kind == "sum128":
                limbs = D.narrow_limb_sums(cols[0], s_valid, seg.sum)
            else:
                limbs = D.wide_limb_sums(*cols, s_valid, seg.sum)
            results.append((limbs, cnt))
        elif spec.kind == "count":
            results.append(cnt)
        elif spec.kind in ("sum", "avg"):
            # an (n, k) input sums lane by lane (the streaming merge packs
            # its integer accumulators so)
            out = seg.sum([torch.where(use, x, torch.zeros_like(x)) for x in cols])
            results.append((out if pair[0].ndim == 2 else out[:, 0], cnt))
        elif spec.kind in ("min", "max"):
            if len(cols) == 2:
                results.append((seg.extreme_wide(*cols, use, spec.kind), cnt))
            else:
                results.append((seg.extreme(cols[0], use, spec.kind), cnt))
        else:
            raise NotImplementedError(f"aggregate kind {spec.kind!r}")
    return (out_key_data, out_key_valid), results, num_groups, overflow


class _SortedSegments:
    """Reductions over rows sorted by group, selected rows first.

    ``starts[g]`` is the first sorted row of group ``g`` (for every
    ``g >= num_groups`` the count of selected rows), found by a binary
    search over the monotone group ids. Integer sums are differences of
    one prefix sum at the group boundaries (exact: the wraparound is
    modular), as in the reference's ``_SortedSegments``; so no row writes
    to a shared address and the unselected rows are never read. Float
    sums and min/max scatter by group id (rows past the capacity and
    unselected rows land in a dump slot)."""

    def __init__(self, changed, s_sel, max_groups: int):
        n = changed.shape[0]
        dev = changed.device
        gid = torch.cumsum(changed.to(torch.int64), 0) - 1
        self._gid = torch.where(s_sel, gid, max_groups).clamp(max=max_groups)
        key = torch.where(s_sel, gid, 1 << 62)
        queries = torch.arange(max_groups + 1, dtype=torch.int64, device=dev)
        self.starts = torch.searchsorted(key, queries)
        self.sizes = self.starts[1:] - self.starts[:-1]
        self.nonempty = self.sizes > 0
        self.first_idx = self.starts[:-1].clamp(max=max(n - 1, 0))
        self._max_groups = max_groups

    def sum(self, lanes):
        """Per-group sums of 1-D sorted-order lanes (zero where unused):
        (max_groups, len(lanes))."""
        if lanes[0].is_floating_point():
            out = lanes[0].new_zeros((self._max_groups + 1, len(lanes)))
            for j, x in enumerate(lanes):
                out[:, j].index_add_(0, self._gid, x)
            return out[: self._max_groups]
        # one prefix sum over the lanes laid end to end (a torch scan along
        # dim 0 of an (n, k) tensor runs one sequential thread per lane on
        # CUDA: 57 s for Q1 at SF10); each lane's boundary differences
        # cancel the lanes before it
        n = lanes[0].shape[0]
        cs = torch.cumsum(torch.cat([x.to(torch.int64) for x in lanes]), 0)
        cs = torch.cat([cs.new_zeros(1), cs])
        offsets = torch.arange(len(lanes), device=cs.device) * n
        at = cs[offsets[:, None] + self.starts[None, :]]
        return (at[:, 1:] - at[:, :-1]).t()

    def _scatter(self, values, reduce: str, ident):
        out = torch.full(
            (self._max_groups + 1,), ident, dtype=values.dtype,
            device=values.device,
        )
        out.scatter_reduce_(0, self._gid, values, reduce, include_self=True)
        return out[: self._max_groups]

    def extreme(self, data, use, kind: str):
        if data.dtype == torch.bool:
            data = data.to(torch.int64)
        ident = _max_ident(data.dtype) if kind == "min" else _min_ident(data.dtype)
        masked = torch.where(use, data, torch.full_like(data, ident))
        return self._scatter(masked, "amin" if kind == "min" else "amax", ident)

    def extreme_wide(self, hi, lo, use, kind: str):
        """Lexicographic min/max of (hi, lo) values: the extreme signed hi
        per group, then the extreme unsigned lo among the rows tied on
        it. Returns (max_groups, 2)."""
        from trino_tpu_torch.ops.decimal128 import _SIGNBIT, sort_operands_wide

        hk, lk = sort_operands_wide(hi, lo)
        best_hi = self.extreme(hk, use, kind)
        tied = use & (hk == torch.cat([best_hi, best_hi[:1]])[self._gid])
        best_lo = self.extreme(lk, tied, kind)
        return torch.stack([best_hi, best_lo ^ _SIGNBIT], dim=1)


def _lanes_at(data, idx):
    """The rows ``idx`` of ``data`` as 1-D lanes, one per column of an
    (n, k) tensor: whole-row gathers of (n, 2) int64 rows (advanced
    indexing and ``index_select`` alike) go to torch's gather kernel for
    long rows, 1.1-1.3 ms per 2^21 rows on the H100; 1-D gathers do not."""
    if data.ndim == 1:
        return (data[idx],)
    return tuple(data[:, j][idx] for j in range(data.shape[1]))


def global_aggregate(
    sel: torch.Tensor,
    agg_inputs: Sequence[tuple[torch.Tensor, torch.Tensor | None] | None],
    agg_specs: Sequence[AggSpec],
):
    """Aggregation without GROUP BY: single group, plain reductions.
    ``sum128``/``sum128w`` give (limb sums (1, 3|5), count) and a wide
    min/max value is (1, 2)."""
    results = []
    for spec, pair in zip(agg_specs, agg_inputs):
        if spec.kind == "count_star":
            results.append(sel.to(torch.int64).sum())
            continue
        data, valid = pair
        use = sel if valid is None else (valid & sel)
        cnt = use.to(torch.int64).sum()
        if spec.kind in ("sum128", "sum128w"):
            from trino_tpu_torch.ops import decimal128 as D

            def total(lanes):
                return torch.stack(lanes).sum(1).reshape(1, len(lanes))

            if spec.kind == "sum128":
                limbs = D.narrow_limb_sums(data, use, total)
            else:
                limbs = D.wide_limb_sums(data[:, 0], data[:, 1], use, total)
            results.append((limbs, cnt))
        elif spec.kind == "count":
            results.append(cnt)
        elif spec.kind in ("sum", "avg"):
            results.append((torch.where(use, data, torch.zeros_like(data)).sum(), cnt))
        elif spec.kind in ("min", "max") and data.ndim == 2:
            from trino_tpu_torch.ops.decimal128 import global_minmax_wide

            bh, bl = global_minmax_wide(data[:, 0], data[:, 1], use, spec.kind)
            results.append((torch.stack([bh, bl], dim=1), cnt))
        elif spec.kind == "min":
            ident = torch.full_like(data, _max_ident(data.dtype))
            results.append((torch.where(use, data, ident).min(), cnt))
        elif spec.kind == "max":
            ident = torch.full_like(data, _min_ident(data.dtype))
            results.append((torch.where(use, data, ident).max(), cnt))
        else:
            raise NotImplementedError(f"aggregate kind {spec.kind!r}")
    return results


def _max_ident(dtype):
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _min_ident(dtype):
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min
