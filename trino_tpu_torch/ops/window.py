"""Window functions.

Reference: ``operator/WindowOperator.java:67`` and the window function
implementations under ``operator/window/``. Counterpart of
``trino_tpu/ops/window.py`` (jnp, outside any Pallas kernel), in plain
torch:

1. one multi-key stable sort puts rows in (partition, order) order,
   unselected rows last (``ops/sort.py::sort_indices``);
2. partition and peer boundaries become boolean flag vectors;
3. every window function is a segmented scan or a gather off running
   values; results scatter back to the original row positions.

torch has no ``associative_scan``, so the scans are built from what it
has: the index of the last flag at or before each row is a ``cummax``
over flag-weighted indices; an integer segmented sum is a ``cumsum``
minus the prefix before the segment's first row, in int64 lanes, which
is exact; segmented min/max and floating-point sums run a log-step
(Hillis-Steele) scan that resets at the flags, the same reset-at-flag
combiner as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from trino_tpu_torch.ops.sort import SortKey, sort_indices


@dataclasses.dataclass(frozen=True)
class WindowSpecKernel:
    """Which frame the aggregate kinds use (ranking kinds ignore it)."""

    # "running_range": UNBOUNDED PRECEDING..CURRENT ROW in RANGE mode
    #   (peers of the current row included: the SQL default with ORDER BY)
    # "running_rows": the same in ROWS mode (exactly the rows up to current)
    # "partition": the whole partition (no ORDER BY, or an explicit
    #   UNBOUNDED PRECEDING..UNBOUNDED FOLLOWING frame)
    # "rows_preceding": ROWS BETWEEN k PRECEDING AND CURRENT ROW
    frame: str = "running_range"
    preceding: int = 0  # k for rows_preceding


@dataclasses.dataclass(frozen=True)
class WindowFn:
    kind: str  # row_number|rank|dense_rank|percent_rank|cume_dist|ntile|nth_value|lead|lag|first_value|last_value|sum|count|count_star|avg|min|max
    offset: int = 1  # lead/lag distance; ntile bucket count; nth_value n
    has_default: bool = False  # lead/lag with an explicit default


def _ne_prev(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """flag[i]: row i differs from row i-1 on this key (NULLs compare
    equal); flag[0] is True."""
    d = torch.where(valid, data, torch.zeros_like(data))
    out = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    out[1:] = (d[1:] != d[:-1]) | (valid[1:] != valid[:-1])
    return out


def _last_flag_idx(flag: torch.Tensor) -> torch.Tensor:
    """For each i, the largest j <= i with flag[j] (flag[0] must be True)."""
    idx = torch.arange(flag.shape[0], dtype=torch.int64, device=flag.device)
    return torch.cummax(torch.where(flag, idx, 0), 0).values


def _next_flag_idx(flag: torch.Tensor) -> torch.Tensor:
    """For each i, the smallest j > i with flag[j], else n."""
    n = flag.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=flag.device)
    a = torch.where(flag, idx, n)
    suffix_min = torch.flip(torch.cummin(torch.flip(a, (0,)), 0).values, (0,))
    out = torch.full_like(suffix_min, n)
    out[:-1] = suffix_min[1:]
    return out


def _segmented_sum_int(values: torch.Tensor, seg_first: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of int64 lanes: the running total minus the
    total before each row's segment start (exact: int64 wraps alike)."""
    cs = torch.cumsum(values, 0)
    return cs - (cs - values)[seg_first]


def _segmented_scan(values: torch.Tensor, seg_start: torch.Tensor, combine):
    """Inclusive segmented scan, ``combine`` resetting at ``seg_start``: a
    log-step scan over (flag, value) pairs with the combiner
    ``(fa | fb, fb ? vb : combine(va, vb))``."""
    v = values.clone()
    f = seg_start.clone()
    n = v.shape[0]
    d = 1
    while d < n:
        nv = v.clone()
        nv[d:] = torch.where(f[d:], v[d:], combine(v[:-d], v[d:]))
        nf = f.clone()
        nf[d:] = f[d:] | f[:-d]
        v, f = nv, nf
        d <<= 1
    return v


def _segmented_sum(values: torch.Tensor, seg_start, seg_first) -> torch.Tensor:
    if values.is_floating_point():
        return _segmented_scan(values, seg_start, torch.add)
    return _segmented_sum_int(values, seg_first)


def _round_half_up_div(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """DECIMAL average: the quotient rounded half up at the argument's
    scale (away from zero on ties)."""
    return torch.where(
        s >= 0,
        torch.div(s + c // 2, c, rounding_mode="floor"),
        -torch.div(-s + c // 2, c, rounding_mode="floor"),
    )


def _extreme_ident(dtype: torch.dtype, is_min: bool):
    if dtype.is_floating_point:
        return torch.finfo(dtype).max if is_min else -torch.finfo(dtype).max
    return torch.iinfo(dtype).max if is_min else torch.iinfo(dtype).min


def compute_windows(
    partition_keys: Sequence[tuple[torch.Tensor, torch.Tensor]],
    partition_ranks: Sequence[Optional[object]],
    order_keys: Sequence[tuple[torch.Tensor, torch.Tensor]],
    order_specs: Sequence[SortKey],
    order_ranks: Sequence[Optional[object]],
    sel: torch.Tensor,
    functions: Sequence[WindowFn],
    fn_args: Sequence[Optional[tuple[torch.Tensor, torch.Tensor]]],
    fn_defaults: Sequence[Optional[tuple[torch.Tensor, torch.Tensor]]],
    frame: WindowSpecKernel,
):
    """Evaluate all window functions sharing one (partition, order, frame)
    spec. Returns (data, valid) pairs aligned to the original row
    positions (unspecified at unselected rows: the caller keeps its
    selection)."""
    n = sel.shape[0]
    dev = sel.device
    perm = sort_indices(
        list(partition_keys) + list(order_keys),
        [SortKey()] * len(partition_keys) + list(order_specs),
        sel,
        list(partition_ranks) + list(order_ranks),
    )
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    s_sel = sel[perm]

    # partition boundaries (NULLs are equal inside a partition key)
    seg_start = torch.ones(n, dtype=torch.bool, device=dev)
    seg_start[1:] = s_sel[1:] != s_sel[:-1]
    for data, valid in partition_keys:
        seg_start = seg_start | _ne_prev(data[perm], valid[perm])
    # peer boundaries (a partition boundary or any order key changes)
    peer_start = seg_start
    for data, valid in order_keys:
        peer_start = peer_start | _ne_prev(data[perm], valid[perm])

    seg_first = _last_flag_idx(seg_start)
    row_number = idx - seg_first + 1
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    cache: dict[str, torch.Tensor] = {}

    def peer_last():
        if "peer_last" not in cache:
            cache["peer_last"] = torch.clamp(_next_flag_idx(peer_start) - 1, max=n - 1)
        return cache["peer_last"]

    def seg_last():
        if "seg_last" not in cache:
            cache["seg_last"] = torch.clamp(_next_flag_idx(seg_start) - 1, max=n - 1)
        return cache["seg_last"]

    def seg_sizes():
        return row_number[seg_last()]

    results: list[tuple[torch.Tensor, torch.Tensor]] = []
    for fn, arg, dflt in zip(functions, fn_args, fn_defaults):
        if fn.kind == "row_number":
            out = (row_number, ones)
        elif fn.kind == "rank":
            out = (_last_flag_idx(peer_start) - seg_first + 1, ones)
        elif fn.kind == "percent_rank":
            rank = (_last_flag_idx(peer_start) - seg_first + 1).to(torch.float64)
            sizes = seg_sizes().to(torch.float64)
            out = (
                torch.where(
                    sizes > 1, (rank - 1) / torch.clamp(sizes - 1, min=1), 0.0
                ),
                ones,
            )
        elif fn.kind == "cume_dist":
            covered = (peer_last() - seg_first + 1).to(torch.float64)
            out = (covered / torch.clamp(seg_sizes().to(torch.float64), min=1), ones)
        elif fn.kind == "nth_value":
            data, valid = arg
            sd, sv = data[perm], valid[perm]
            if frame.frame == "rows_preceding":
                start = torch.maximum(seg_first, idx - frame.preceding)
            else:
                start = seg_first
            pos = start + fn.offset - 1
            if frame.frame == "partition":
                end = seg_last()
            elif frame.frame in ("running_rows", "rows_preceding"):
                end = idx
            else:  # running_range: the frame extends through the peers
                end = peer_last()
            posc = torch.clamp(pos, 0, n - 1)
            out = (sd[posc], sv[posc] & (pos <= end))
        elif fn.kind == "dense_rank":
            c = torch.cumsum(peer_start.to(torch.int64), 0)
            c_at_seg = torch.cummax(torch.where(seg_start, c, 0), 0).values
            out = (c - c_at_seg + 1, ones)
        elif fn.kind == "ntile":
            sizes = seg_sizes()
            out = (
                torch.div(
                    (row_number - 1) * fn.offset, torch.clamp(sizes, min=1),
                    rounding_mode="floor",
                ) + 1,
                ones,
            )
        elif fn.kind in ("lead", "lag"):
            data, valid = arg
            sd, sv = data[perm], valid[perm]
            j = idx + (fn.offset if fn.kind == "lead" else -fn.offset)
            jc = torch.clamp(j, 0, n - 1)
            in_seg = (seg_first[jc] == seg_first) & (j >= 0) & (j < n) & s_sel[jc]
            cand_d, cand_v = sd[jc], sv[jc] & in_seg
            if dflt is not None:
                dd, dv = dflt
                cand_d = torch.where(in_seg, cand_d, dd[perm].to(cand_d.dtype))
                cand_v = torch.where(in_seg, cand_v, dv[perm])
            out = (cand_d, cand_v)
        elif fn.kind == "first_value":
            data, valid = arg
            sd, sv = data[perm], valid[perm]
            if frame.frame == "rows_preceding":
                start = torch.maximum(seg_first, idx - frame.preceding)
            else:
                start = seg_first
            out = (sd[start], sv[start])
        elif fn.kind == "last_value":
            data, valid = arg
            sd, sv = data[perm], valid[perm]
            if frame.frame == "partition":
                out = (sd[seg_last()], sv[seg_last()])
            elif frame.frame in ("running_rows", "rows_preceding"):
                out = (sd, sv)  # the frame ends at the current row
            else:
                out = (sd[peer_last()], sv[peer_last()])
        else:
            out = _frame_aggregate(
                fn, arg, perm, s_sel, seg_start, seg_first, idx, frame,
                peer_last, seg_last,
            )

        # scatter back to the original positions
        od, ov = out
        rd = torch.zeros_like(od)
        rd[perm] = od
        rv = torch.zeros_like(ov)
        rv[perm] = ov
        results.append((rd, rv))
    return results


def _frame_aggregate(fn, arg, perm, s_sel, seg_start, seg_first, idx, frame,
                     peer_last, seg_last):
    """sum/avg/count/count_star/min/max over the frame, in sorted order."""
    if frame.frame == "rows_preceding":
        return _rows_preceding_agg(fn, arg, perm, s_sel, seg_first, idx, frame.preceding)
    n = s_sel.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=s_sel.device)
    if fn.kind == "count_star":
        out_d, out_v = _segmented_sum_int(s_sel.to(torch.int64), seg_first), ones
    else:
        data, valid = arg
        sd = data[perm]
        sv = valid[perm] & s_sel
        rc = _segmented_sum_int(sv.to(torch.int64), seg_first)
        if fn.kind == "count":
            out_d, out_v = rc, ones
        elif fn.kind in ("sum", "avg"):
            acc = sd.dtype if sd.is_floating_point() else torch.int64
            vals = torch.where(sv, sd, torch.zeros_like(sd)).to(acc)
            rs = _segmented_sum(vals, seg_start, seg_first)
            if fn.kind == "sum":
                out_d = rs
            elif sd.is_floating_point():
                out_d = rs / torch.clamp(rc, min=1)
            else:  # DECIMAL avg: round half up at the argument's scale
                out_d = _round_half_up_div(rs, torch.clamp(rc, min=1))
            out_v = rc > 0
        else:  # min / max
            is_min = fn.kind == "min"
            ident = _extreme_ident(sd.dtype, is_min)
            vals = torch.where(sv, sd, torch.full_like(sd, ident))
            out_d = _segmented_scan(
                vals, seg_start, torch.minimum if is_min else torch.maximum
            )
            out_v = rc > 0
    # frame adjustment: whole-partition totals or the peer-extended value
    if frame.frame == "partition":
        return out_d[seg_last()], out_v[seg_last()]
    if frame.frame == "running_range":
        return out_d[peer_last()], out_v[peer_last()]
    return out_d, out_v


def _rows_preceding_agg(fn, arg, perm, s_sel, seg_first, idx, k):
    """ROWS BETWEEN k PRECEDING AND CURRENT ROW for sum/avg/count/min/max:
    the k+1-row window clipped at the partition start."""
    n = s_sel.shape[0]
    if fn.kind == "count_star":
        sv = s_sel
        sd = torch.ones(n, dtype=torch.int64, device=s_sel.device)
    else:
        data, valid = arg
        sd = data[perm]
        sv = valid[perm] & s_sel
    if fn.kind in ("min", "max"):
        is_min = fn.kind == "min"
        ident = torch.full_like(sd, _extreme_ident(sd.dtype, is_min))
        op = torch.minimum if is_min else torch.maximum
        acc = torch.where(sv, sd, ident)
        cnt = sv.to(torch.int64)
        for s in range(1, k + 1):
            j = idx - s
            ok = j >= seg_first
            jc = torch.clamp(j, min=0)
            acc = op(acc, torch.where(ok & sv[jc], sd[jc], ident))
            cnt = cnt + torch.where(ok, sv[jc].to(torch.int64), 0)
        return acc, cnt > 0
    # additive kinds: running-sum differences over k+1 rows
    floating = sd.is_floating_point()
    vals = torch.where(sv, sd, torch.zeros_like(sd)).to(sd.dtype if floating else torch.int64)
    seg_start = idx == seg_first
    rs = _segmented_sum(vals, seg_start, seg_first)
    rc = _segmented_sum_int(sv.to(torch.int64), seg_first)
    j = idx - (k + 1)
    ok = j >= seg_first
    jc = torch.clamp(j, min=0)
    wsum = rs - torch.where(ok, rs[jc], torch.zeros_like(rs))
    wcnt = rc - torch.where(ok, rc[jc], 0)
    ones = torch.ones(n, dtype=torch.bool, device=s_sel.device)
    if fn.kind == "count":
        return wcnt, ones
    if fn.kind == "count_star":
        return wsum, ones
    if fn.kind == "sum":
        return wsum, wcnt > 0
    safe = torch.clamp(wcnt, min=1)
    if floating:
        return wsum / safe, wcnt > 0
    return _round_half_up_div(wsum, safe), wcnt > 0
