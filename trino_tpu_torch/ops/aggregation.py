"""Group-by aggregation: sort into groups, reduce per group.

Reference semantics: ``operator/HashAggregationOperator.java:49`` and the
aggregation function triple input/combine/output
(``operator/aggregation/LongSumAggregation.java:29-55``).

Counterpart of ``trino_tpu/ops/aggregation.py`` with the same contract
(outputs, capacity, overflow flag). The reference avoids scatter because
XLA:TPU serializes it; on a GPU ``index_add_`` and ``scatter_reduce_``
are the natural per-group reductions, so rows are sorted only to number
the groups and every reduction scatters by group id.

Partial/final split: the same function serves both; COUNT partials
re-aggregate with SUM, AVG decomposes into SUM+COUNT (Trino's
input/combine/output contract for distributed aggregation). The exact
128-bit DECIMAL accumulators (``sum128``/``sum128w``) are not ported yet.
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


def _not_ported(kind: str):
    return NotImplementedError(
        f"aggregate kind {kind!r} is not yet ported to trino_tpu_torch"
    )


def group_aggregate(
    keys: Sequence[tuple[torch.Tensor, torch.Tensor | None]],
    sel: torch.Tensor,
    agg_inputs: Sequence[tuple[torch.Tensor, torch.Tensor | None] | None],
    agg_specs: Sequence[AggSpec],
    max_groups: int,
):
    """Grouped aggregation.

    Args:
      keys: per key column (data, valid-or-None), each shape (n,).
      sel: bool (n,) — rows participating.
      agg_inputs: per agg (data, valid-or-None) or None for count(*).
      agg_specs: kinds aligned with agg_inputs.
      max_groups: output capacity (groups beyond are dropped and the
        overflow flag is set).

    Returns:
      (group_key_data, group_key_valid): lists of (max_groups,) tensors
      agg_results: count kinds give counts; the others (value, count)
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
    # group id per sorted row; unselected rows and groups past the
    # capacity land in the dump slot ``max_groups``
    gid = torch.cumsum(changed.to(torch.int64), 0) - 1
    gid = torch.where(s_sel, gid, max_groups).clamp(max=max_groups)
    row_gid = torch.empty_like(gid)
    row_gid[perm] = gid  # group id of each input row

    def per_group(values: torch.Tensor, reduce: str = "sum", ident=0):
        out = torch.full(
            (max_groups + 1,), ident, dtype=values.dtype, device=dev
        )
        if reduce == "sum":
            out.index_add_(0, row_gid, values)
        else:
            out.scatter_reduce_(0, row_gid, values, reduce, include_self=True)
        return out[:max_groups]

    ones = torch.ones(n, dtype=torch.int64, device=dev)
    sizes = per_group(ones)
    nonempty = sizes > 0
    # each group's first sorted row gives its key values
    pos = torch.arange(n, device=dev)
    starts = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
    starts.index_copy_(0, gid[changed], pos[changed])
    first_rows = perm[starts[:max_groups]] if n else starts[:max_groups]
    out_key_data, out_key_valid = [], []
    for data, valid in keys:
        g = data[first_rows] if n else data.new_zeros((max_groups,) + data.shape[1:])
        kv = nonempty if valid is None else (valid[first_rows] & nonempty)
        mask = kv[:, None] if g.ndim == 2 else kv
        out_key_data.append(torch.where(mask, g, torch.zeros_like(g)))
        out_key_valid.append(kv)

    results = []
    for spec, pair in zip(agg_specs, agg_inputs):
        if spec.kind == "count_star":
            results.append(sizes)
            continue
        if spec.kind in ("sum128", "sum128w"):
            raise _not_ported(spec.kind)
        data, valid = pair
        if data.ndim == 2:
            raise _not_ported(f"{spec.kind} over wide DECIMAL")
        use = sel if valid is None else (sel & valid)
        cnt = per_group(use.to(torch.int64))
        if spec.kind == "count":
            results.append(cnt)
        elif spec.kind in ("sum", "avg"):
            contrib = torch.where(use, data, torch.zeros_like(data))
            results.append((per_group(contrib), cnt))
        elif spec.kind in ("min", "max"):
            if data.dtype == torch.bool:
                data = data.to(torch.int64)
            ident = _max_ident(data.dtype) if spec.kind == "min" else _min_ident(data.dtype)
            masked = torch.where(use, data, torch.full_like(data, ident))
            red = "amin" if spec.kind == "min" else "amax"
            results.append((per_group(masked, red, ident), cnt))
        else:
            raise _not_ported(spec.kind)
    return (out_key_data, out_key_valid), results, num_groups, overflow


def global_aggregate(
    sel: torch.Tensor,
    agg_inputs: Sequence[tuple[torch.Tensor, torch.Tensor | None] | None],
    agg_specs: Sequence[AggSpec],
):
    """Aggregation without GROUP BY: single group, plain reductions."""
    results = []
    for spec, pair in zip(agg_specs, agg_inputs):
        if spec.kind == "count_star":
            results.append(sel.to(torch.int64).sum())
            continue
        if spec.kind in ("sum128", "sum128w"):
            raise _not_ported(spec.kind)
        data, valid = pair
        if data.ndim == 2:
            raise _not_ported(f"{spec.kind} over wide DECIMAL")
        use = sel if valid is None else (valid & sel)
        cnt = use.to(torch.int64).sum()
        if spec.kind == "count":
            results.append(cnt)
        elif spec.kind in ("sum", "avg"):
            results.append((torch.where(use, data, torch.zeros_like(data)).sum(), cnt))
        elif spec.kind == "min":
            ident = torch.full_like(data, _max_ident(data.dtype))
            results.append((torch.where(use, data, ident).min(), cnt))
        elif spec.kind == "max":
            ident = torch.full_like(data, _min_ident(data.dtype))
            results.append((torch.where(use, data, ident).max(), cnt))
        else:
            raise _not_ported(spec.kind)
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
