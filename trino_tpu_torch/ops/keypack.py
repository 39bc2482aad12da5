"""Grouping order for multi-column keys.

Counterpart of ``trino_tpu/ops/keypack.py``. The reference bit-packs key
columns into a few integer lanes because XLA:TPU sort cost grows with
operand count; torch's radix sort on CUDA sorts one lane at a time, so
here the key columns stay separate lanes and the order is built by
stable sorts from the least to the most significant lane.
"""

from __future__ import annotations

from typing import Sequence

import torch


def key_lanes(
    keys: Sequence[tuple[torch.Tensor, torch.Tensor | None]],
    sel: torch.Tensor,
) -> list[torch.Tensor]:
    """Sort lanes, most significant first: unselected rows last, then per
    key its NULL flag (NULLs last) and its value (zeroed under NULL so all
    NULLs of a key compare equal). Wide (n, 2) keys give two lanes."""
    lanes = [(~sel).to(torch.int64)]
    for data, valid in keys:
        if valid is not None:
            lanes.append((~valid).to(torch.int64))
        cols = [data[:, 0], data[:, 1]] if data.ndim == 2 else [data]
        for c in cols:
            if not c.is_floating_point():
                c = c.to(torch.int64)
            if valid is not None:
                c = torch.where(valid, c, torch.zeros_like(c))
            lanes.append(c)
    return lanes


def grouping_sort(
    keys: Sequence[tuple[torch.Tensor, torch.Tensor | None]],
    sel: torch.Tensor,
):
    """Sort rows so equal (sel, keys...) tuples are adjacent, selected
    rows first. Returns ``(eq_lanes, perm, s_sel)``: the sorted lanes
    (adjacent-row equality over all of them means all keys equal), the
    permutation, and the sorted selection mask."""
    lanes = key_lanes(keys, sel)
    n = sel.shape[0]
    perm = torch.arange(n, device=sel.device)
    for lane in reversed(lanes):
        order = torch.sort(lane[perm], stable=True).indices
        perm = perm[order]
    s_lanes = [lane[perm] for lane in lanes]
    return s_lanes, perm, s_lanes[0] == 0
