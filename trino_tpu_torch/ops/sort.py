"""ORDER BY / TopN ordering.

Reference: ``operator/OrderByOperator.java:45`` (PagesIndex sort),
``operator/TopNOperator.java:37``. Counterpart of ``trino_tpu/ops/sort.py``:
each key column maps to operands already oriented for one ascending sort
(a NULL-position lane, then the value: integers complemented for DESC,
floats negated, strings as dictionary ranks, a wide DECIMAL as its signed
hi and unsigned lo lanes), and the permutation orders
rows lexicographically by those operands, ties by row index. The
reference bit-packs the operands for one XLA sort; here stable sorts run
from the least to the most significant operand, which gives the same
order. Plan nodes carry a :class:`SortKey` per ORDER BY item.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SortKey:
    ascending: bool = True
    nulls_first: bool = False  # Trino default: NULLS LAST for ASC


def sortable_key(data: torch.Tensor, valid: torch.Tensor, key: SortKey,
                 ranks=None) -> list[torch.Tensor]:
    """Sort operands of one key column (NULL key, value), oriented for an
    ascending sort."""
    null_key = valid if key.nulls_first else ~valid
    if data.ndim == 2:  # wide DECIMAL: signed hi, then unsigned lo
        from trino_tpu_torch.ops.decimal128 import sort_operands_wide

        lanes = sort_operands_wide(data[:, 0], data[:, 1], key.ascending)
        return [null_key] + [
            torch.where(valid, x, torch.zeros_like(x)) for x in lanes
        ]
    if ranks is not None:  # dictionary string: map codes to ranks
        r = torch.as_tensor(ranks, device=data.device)
        if r.shape[0] == 0:
            value = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
        else:
            value = r[torch.clamp(data, min=0).long()].to(torch.int64)
        if not key.ascending:
            value = -1 - value
    elif data.is_floating_point():
        value = data if key.ascending else -data
    elif data.dtype == torch.bool:
        value = data.to(torch.int32)
        if not key.ascending:
            value = -value
    else:
        value = data.to(torch.int64)
        if not key.ascending:
            value = -1 - value  # bitwise complement keeps the order reversed
    value = torch.where(valid, value, torch.zeros_like(value))
    return [null_key, value]


def sort_indices(
    key_arrays: Sequence[tuple[torch.Tensor, torch.Tensor]],
    keys: Sequence[SortKey],
    sel: torch.Tensor,
    ranks_per_key=None,
) -> torch.Tensor:
    """Permutation putting selected rows first in key order (ties broken
    by original row index)."""
    ops: list[torch.Tensor] = [~sel]
    for i, ((data, valid), k) in enumerate(zip(key_arrays, keys)):
        ranks = ranks_per_key[i] if ranks_per_key else None
        ops.extend(sortable_key(data, valid, k, ranks))
    perm = torch.arange(sel.shape[0], device=sel.device)
    for op in reversed(ops):
        if op.dtype == torch.bool:
            op = op.to(torch.uint8)
        perm = perm[torch.sort(op[perm], stable=True).indices]
    return perm
