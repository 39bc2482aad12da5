"""Exchange kernels: repartition and broadcast as mesh collectives.

Counterpart of ``trino_tpu/parallel/exchange.py`` (Trino's data plane:
``PartitionedOutputOperator.java:55`` hash-partitions pages to N buffers,
``BroadcastOutputBuffer`` replicates them):

- hash repartition: bucket rows by destination shard, pad the buckets to
  a fixed per-destination capacity, ``all_to_all`` the ``[n_dst, B]``
  blocks and re-flatten; a validity mask marks live rows. Fixed-size
  blocks replace the reference's backpressured streaming;
- broadcast: ``all_gather`` (replicate the build side).

A destination receiving more than B rows from one source is reported by
a flag; the caller retries with a larger bucket.

Each body runs once over the ``[n, m]`` view of every shard
(``parallel/mesh.py``), where the collectives are a transpose (all to
all), a concatenation seen by every shard (all gather) and a reduction
over the shard axis (psum, pmax). On a mesh over processes the view is
this process's local shards, ``n`` stays the mesh's shard count (the
destinations), and the collectives cross processes. As in the
reference, one sort a shard orders the rows by destination: the
destination and the row index share one integer lane (``dest <<
idx_bits | row``), int32 or int64 (``wide``) as the reference picks, so
the sort needs no second operand.
"""

from __future__ import annotations

from typing import Sequence

import torch

from trino_tpu_torch.parallel import mesh as M


def _dest_sort(dest: torch.Tensor, n_ids: int):
    """Per shard, rows ordered by destination (``dest`` ``[n, m]`` in
    ``[0, n_ids)``): ``(order, d_sorted, counts, within)`` where
    ``within`` is each sorted row's position in its destination's run."""
    n, local_n = dest.shape
    dev = dest.device
    idx_bits = max(1, (local_n - 1).bit_length())
    wide = idx_bits + (n_ids - 1).bit_length() > 31
    lt = torch.int64 if wide else torch.int32
    rows = torch.arange(local_n, dtype=lt, device=dev)
    lane = (dest.to(lt) << idx_bits) | rows
    s_lane = torch.sort(lane, dim=1).values
    order = (s_lane & ((1 << idx_bits) - 1)).long()
    d_sorted = (s_lane >> idx_bits).long()
    counts = torch.zeros((n, n_ids), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, d_sorted, torch.ones_like(d_sorted))
    starts = torch.cumsum(counts, 1) - counts
    within = rows.long() - torch.gather(starts, 1, d_sorted)
    return order, d_sorted, counts, within


def _scatter_rows(values: torch.Tensor, slot: torch.Tensor, total: int, fill=0) -> torch.Tensor:
    """Per shard, ``values`` ``[n, m, ...]`` written at ``slot`` ``[n, m]``
    into ``[n, total, ...]`` buffers; a slot of ``total`` or more is
    dropped (``.at[slot].set(mode="drop")``)."""
    n = values.shape[0]
    buf = values.new_full((n, total + 1) + tuple(values.shape[2:]), fill)
    slot = torch.clamp(slot, max=total)
    idx = slot.reshape(slot.shape + (1,) * (values.ndim - 2)).expand(values.shape)
    buf.scatter_(1, idx, values)
    return buf[:, :total]


def _take_rows(c: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per shard, ``c`` ``[n, m, ...]`` gathered in ``order`` ``[n, m]``."""
    idx = order.reshape(order.shape + (1,) * (c.ndim - 2)).expand(order.shape + tuple(c.shape[2:]))
    return torch.gather(c, 1, idx)


def hash_repartition(mesh: M.Mesh, arrays: Sequence[torch.Tensor], key_hash: torch.Tensor,
                     sel: torch.Tensor, bucket: int):
    """Repartition rows so that row ``r`` lands on shard
    ``key_hash[r] mod n`` (reference :31-113).

    ``arrays`` are global row-sharded columns; rows with ``sel`` False go
    nowhere; ``bucket`` is the per-(src, dst) block capacity B. Returns
    ``(out_arrays, out_sel, overflow)``: per shard ``n * B`` rows (global
    ``n * n * B``), the live rows' mask, and an int32 flag (any block
    overflowed)."""
    n, nl = mesh.size, mesh.local
    khash = M.shard_view(key_hash, nl)
    s = M.shard_view(sel, nl)
    # floor modulo, as jnp's % on signed hashes
    dest = torch.where(s, torch.remainder(khash, n), n)
    order, d_sorted, counts, within = _dest_sort(dest, n + 1)
    overflow = (counts[:, :n] > bucket).any(1)
    live = (d_sorted < n) & (within < bucket)
    slot = torch.where(live, d_sorted * bucket + within, n * bucket)
    valid_block = _scatter_rows(live, slot, n * bucket, False)
    out_cols = []
    for a in arrays:
        b = _scatter_rows(_take_rows(M.shard_view(a, nl), order), slot, n * bucket)
        blocks = b.reshape((nl, n, bucket) + tuple(a.shape[1:]))
        out_cols.append(M.flat(M.all_to_all(blocks, mesh)))
    out_valid = M.flat(M.all_to_all(valid_block.reshape(nl, n, bucket), mesh))
    return out_cols, out_valid, M.pmax(overflow.to(torch.int32), mesh)


def skewed_repartition(mesh: M.Mesh, arrays: Sequence[torch.Tensor], key_hash: torch.Tensor,
                       sel: torch.Tensor, bucket: int, spill: int, hot_mode=None,
                       hot_cap: int = 0, hot_set=None, detect=None):
    """Two-tier (and optionally salted) repartition (reference :116-296).

    A small per-(src, dst) cold ``bucket`` plus a shared ``spill`` tier:
    rows past their cold block pack into one per-source ``[spill]`` block
    that is all-gathered with a destination lane, and each receiver keeps
    the spill rows addressed to it, so the rows land as
    ``hash_repartition`` lands them. Skew handling adds a *hot* region for
    keys of a heavy-hitter set (``ops/skew.py``), which never touch the
    cold or spill tiers: ``hot_mode="local"`` (probe side) keeps hot rows
    on their source shard; ``hot_mode="replicate"`` (build side)
    all-gathers each source's hot rows to every shard. The hot set comes
    from ``hot_set=(hot_hashes, hot_valid)`` or, with ``detect=(k,
    frac)``, from the sketch over this exchange's own hashes.

    Returns ``(out_cols, out_sel, flags, counters, hotset)``: ``flags``
    ``(spill_overflow, hot_overflow)`` int32; ``counters`` ``(sent_rows,
    hot_rows, hot_keys)`` int64 (live rows entering the exchange, rows
    routed hot, hot keys); ``hotset`` ``(hot_hashes, hot_valid, n_hot)``
    with ``detect``, else ``()``. A shard's output is ``n * bucket + n *
    spill + H`` rows, H being 0, ``hot_cap`` (local) or ``n * hot_cap``
    (replicate)."""
    from trino_tpu_torch.ops import skew as SK

    n, nl = mesh.size, mesh.local
    assert hot_mode in (None, "local", "replicate")
    assert (hot_mode is None) == (hot_set is None and detect is None)
    khash = M.shard_view(key_hash, nl)
    s = M.shard_view(sel, nl)
    hotset_out = ()
    if hot_set is not None:
        hh, hv = hot_set
        n_hot = hv.sum(dtype=torch.int64)
    elif detect is not None:
        k, frac = detect
        hh, hv, n_hot, _total = SK.hot_key_sketch(khash, s, k, frac, mesh)
        hotset_out = (hh, hv, n_hot)
    else:
        hh = hv = None
        n_hot = torch.zeros((), dtype=torch.int64, device=key_hash.device)
    dest = torch.remainder(khash, n)
    if hh is not None:
        dest = torch.where(SK.is_hot(hh, hv, khash) & s, n, dest)
    dest = torch.where(s, dest, n + 1)  # n: hot, n + 1: dead (dropped)
    order, d_sorted, counts, within = _dest_sort(dest, n + 2)
    cold = d_sorted < n
    in_cold = cold & (within < bucket)
    sp = (cold & (within >= bucket)).long()
    spill_pos = torch.cumsum(sp, 1) - sp
    n_spilled = sp.sum(1)
    hot_region = hot_cap if hot_mode is not None else 0
    base_spill = n * bucket
    base_hot = base_spill + spill
    total_slots = base_hot + hot_region
    slot = torch.where(in_cold, d_sorted * bucket + within, total_slots)
    slot = torch.where((sp > 0) & (spill_pos < spill), base_spill + spill_pos, slot)
    if hot_mode is not None:
        slot = torch.where((d_sorted == n) & (within < hot_cap), base_hot + within, slot)
    landed = slot < total_slots
    valid_buf = _scatter_rows(landed, slot, total_slots, False)
    dest_buf = _scatter_rows(d_sorted, slot, total_slots, n)

    def ship(buf):
        rest = tuple(buf.shape[2:])
        cold_out = M.all_to_all(buf[:, :base_spill].reshape((nl, n, bucket) + rest), mesh)
        spill_out = M.all_gather(buf[:, base_spill:base_hot], mesh)
        parts = [cold_out, spill_out.expand((nl,) + tuple(spill_out.shape))]
        if hot_mode == "replicate":
            hot_out = M.all_gather(buf[:, base_hot:], mesh)
            parts.append(hot_out.expand((nl,) + tuple(hot_out.shape)))
        elif hot_mode == "local":
            parts.append(buf[:, base_hot:])
        return M.flat(torch.cat(parts, 1))

    out_cols = [
        ship(_scatter_rows(_take_rows(M.shard_view(a, nl), order), slot, total_slots))
        for a in arrays
    ]
    out_valid = ship(valid_buf)
    # spill rows were gathered everywhere: each shard keeps its own
    gdest = M.all_gather(dest_buf[:, base_spill:base_hot], mesh)
    per_shard = out_valid.shape[0] // nl
    me = mesh.first + torch.arange(nl, device=key_hash.device).unsqueeze(1)
    keep = torch.ones((nl, per_shard), dtype=torch.bool, device=key_hash.device)
    keep[:, base_spill:base_spill + n * spill] = gdest.unsqueeze(0) == me
    out_valid = out_valid & keep.reshape(-1)
    zero = torch.zeros((), dtype=torch.int32, device=key_hash.device)
    flags = (
        M.pmax((n_spilled > spill).to(torch.int32), mesh),
        M.pmax((counts[:, n] > hot_cap).to(torch.int32), mesh) if hot_mode is not None
        else zero,
    )
    # live rows entering the exchange (the padding ratio's denominator);
    # hot-local rows count too, so skew on and off share a baseline
    counters = (M.psum(s.sum(1, dtype=torch.int64), mesh), M.psum(counts[:, n], mesh), n_hot)
    return out_cols, out_valid, flags, counters, hotset_out


def skew_split_counts(mesh: M.Mesh, key_hash: torch.Tensor, sel: torch.Tensor,
                      hot_hashes: torch.Tensor, hot_valid: torch.Tensor) -> tuple[int, int]:
    """Exact sizing of a hybrid exchange (reference :299): the largest
    per-(src, dst) count of *cold* rows and the largest per-source count
    of *hot* rows, at least 8 each. One host read."""
    from trino_tpu_torch.ops import skew as SK

    n, nl = mesh.size, mesh.local
    khash = M.shard_view(key_hash, nl)
    s = M.shard_view(sel, nl)
    dest = torch.where(s, torch.remainder(khash, n), n + 1)
    dest = torch.where(SK.is_hot(hot_hashes, hot_valid, khash) & s, n, dest)
    counts = _counts(dest, n + 2)
    both = torch.stack([M.pmax(counts[:, :n].amax(1), mesh),
                        M.pmax(counts[:, n], mesh)]).tolist()
    return max(8, int(both[0])), max(8, int(both[1]))


def _counts(dest: torch.Tensor, n_ids: int) -> torch.Tensor:
    counts = torch.zeros((dest.shape[0], n_ids), dtype=torch.int64, device=dest.device)
    return counts.scatter_add_(1, dest.long(), torch.ones_like(dest, dtype=torch.int64))


def needed_bucket(mesh: M.Mesh, key_hash: torch.Tensor, sel: torch.Tensor) -> int:
    """Exact per-(src, dst) bucket of ``hash_repartition`` (reference
    :344): the most rows any source sends any destination, at least 8.
    One host read; it spares the overflow retries."""
    n, nl = mesh.size, mesh.local
    khash = M.shard_view(key_hash, nl)
    s = M.shard_view(sel, nl)
    dest = torch.where(s, torch.remainder(khash, n), n)
    counts = _counts(dest, n + 1)[:, :n]
    return max(8, int(M.pmax(counts.amax(1), mesh)))


def broadcast_all(mesh: M.Mesh, arrays: Sequence[torch.Tensor], sel: torch.Tensor):
    """Replicate row-sharded arrays to every shard (build-side broadcast,
    reference :376): the full-length arrays and selection, padded to a
    multiple of the mesh (padding rows unselected), seen by every shard.
    On a mesh over processes the arrays are this process's shards."""
    nl = mesh.local
    arrays = [M.pad_rows_to(a, nl) for a in arrays]
    sel = M.pad_rows_to(sel, nl, False)
    return ([M.all_gather(M.shard_view(a, nl), mesh) for a in arrays],
            M.all_gather(M.shard_view(sel, nl), mesh))
