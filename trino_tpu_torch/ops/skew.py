"""Heavy-hitter (skew) detection: a top-k frequency sketch on the device.

Counterpart of ``trino_tpu/ops/skew.py``. A skewed join key (Zipf
customers, hot dates) makes ``hash_repartition`` size every (src, dst)
block for the hottest destination and retry on overflow. The sketch finds
keys hot enough to threaten a per-destination bucket, so the exchange can
route them on a separate path (``parallel/exchange.py::
skewed_repartition``).

Each shard sorts its live key hashes, takes its local top-k distinct keys
by run length, all-gathers the ``n * k`` candidates and sums exact
global counts for every candidate. A key is *hot* when its global count
exceeds ``threshold_frac`` of the per-shard fair share (``total_rows /
n_shards``). A key outside every shard's top-k stays on the cold path
(the spill tier catches it): a miss costs padding, never correctness.

The body runs once over the ``[n, m]`` view of all shards
(``parallel/mesh.py``), this process's local shards on a mesh over
processes, whose candidates and counts cross processes; every process
then picks the same hot set. The reference sorts the candidates on their count
alone, unstably (``skew.py:62``), so on a tie at the k-th candidate
XLA's pick is unspecified; this port sorts by ``(-count, hash)``. The
hot sets can then differ on such ties, the rows never: routing is a
partition of the rows by exact hash membership.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.parallel import mesh as M

# int64 max marks dead rows / empty candidate slots; it sorts last and is
# excluded from hotness explicitly (dead rows would otherwise form a run)
_SENTINEL = (1 << 63) - 1


def hot_key_sketch(khash: torch.Tensor, sel: torch.Tensor, k: int, threshold_frac: float,
                   mesh=None):
    """The sketch over every shard (reference ``hot_key_sketch``, :37).

    Args:
      khash: ``[n, m]`` int64 key hashes, one row a shard (this process's
        local shards on a ``mesh`` over processes, whose candidates and
        counts then cross processes).
      sel: ``[n, m]`` bool liveness.
      k: candidates kept per shard.
      threshold_frac: hot iff global count > frac * total_live / n.

    Returns ``(hot_hashes, hot_valid, n_hot, total_live)``: the sorted
    candidate table of ``n * k`` hashes that every shard sees (duplicates
    and cold or empty slots masked by ``hot_valid``), the hot-key count
    and the global live-row count (int64 scalars).
    """
    nl, m = khash.shape
    n = nl if mesh is None else mesh.size
    dev = khash.device
    skey = torch.sort(torch.where(sel, khash, _SENTINEL), dim=1).values
    pos = torch.arange(m, dtype=torch.int64, device=dev).expand(nl, m)
    left = torch.searchsorted(skey, skey, side="left")
    right = torch.searchsorted(skey, skey, side="right")
    # one candidate per distinct key: its first occurrence carries the
    # run length; everything else competes with count 0
    cand_count = torch.where((pos == left) & (skey != _SENTINEL), right - left, 0)
    # (-count, hash): skey is ascending, so a stable sort on -count
    order = torch.sort(-cand_count, dim=1, stable=True).indices
    neg_sorted = torch.gather(-cand_count, 1, order)
    cand = torch.gather(skey, 1, order)
    kk = min(k, m)
    top = torch.where(-neg_sorted[:, :kk] > 0, cand[:, :kk], _SENTINEL)
    if kk < k:
        top = torch.cat([top, top.new_full((nl, k - kk), _SENTINEL)], dim=1)
    gcand = M.all_gather(top, mesh)  # [n * k], seen by every shard
    # exact global count for every candidate (psum of local run lengths)
    probe = gcand.expand(nl, gcand.shape[0]).contiguous()
    lo = torch.searchsorted(skey, probe, side="left")
    hi = torch.searchsorted(skey, probe, side="right")
    gcount = M.psum(hi - lo, mesh)
    total = M.psum(sel.sum(1, dtype=torch.int64), mesh)
    hot = gcount.to(torch.float64) * n > threshold_frac * total.to(torch.float64)
    hot = hot & (gcand != _SENTINEL)
    # sorted by hash for searchsorted membership; duplicates of a hash
    # share one global count (one hot flag), so the first carries it
    sh, idx = torch.sort(gcand)
    hflag = hot[idx]
    first = torch.arange(sh.shape[0], device=dev) == torch.searchsorted(sh, sh, side="left")
    hvalid = first & hflag
    n_hot = hvalid.sum(dtype=torch.int64)
    return sh, hvalid, n_hot, total


def is_hot(hot_hashes: torch.Tensor, hot_valid: torch.Tensor, khash: torch.Tensor) -> torch.Tensor:
    """Membership of each ``khash`` in the sketch's hot set (reference
    :92); ``hot_hashes`` is the sorted table of :func:`hot_key_sketch`."""
    flat = khash.reshape(-1)
    idx = torch.searchsorted(hot_hashes, flat, side="left")
    idx = torch.clamp(idx, max=hot_hashes.shape[0] - 1)
    return ((hot_hashes[idx] == flat) & hot_valid[idx]).reshape(khash.shape)


def hot_key_hashes(mesh: M.Mesh, key_hash: torch.Tensor, sel: torch.Tensor, k: int,
                   threshold_frac: float):
    """The sketch over global row-sharded ``key_hash``/``sel`` (reference
    :103): ``(hot_hashes, hot_valid, n_hot, total_live)``, seen by every
    shard."""
    nl = mesh.local
    return hot_key_sketch(M.shard_view(key_hash, nl), M.shard_view(sel, nl), k,
                          threshold_frac, mesh)
