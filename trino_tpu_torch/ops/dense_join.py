"""Dense equi-join tier: an open-addressing build table of row ids.

Counterpart of ``trino_tpu/ops/dense_join.py`` — the translation of
Trino's ``PagesHash`` linear-probe table — with the same contracts:

1. The build runs in rounds: in round ``d`` (``d < W``,
   ``W = PROBE_WINDOW``) every live build row not yet placed proposes
   itself for slot ``(base + d) & (cap - 1)``; a slot that was vacant when
   the round began takes the smallest proposing row id. Rows that find no
   slot within W rounds set the table-overflow flag, and the executor's
   retry ladder re-hashes at doubled capacity (``densejoin`` capacity
   sites); duplicate-key chains longer than W can never place, and the
   executor demotes such a site to the sort tier.
2. The probe gathers the same W slots per probe row and keeps entries whose
   build hash equals the probe hash, expanding matches into the sort tier's
   ``probe_join`` contract, so ``verify_equal`` and everything downstream
   are shared. Among equal hashes round r places the r-th smallest row id,
   so one probe row's matches come out in ascending build row order.

The build is kernel K2. On a CUDA tensor :func:`build_table_device` launches
``csrc/dense_join_build.cu``, which computes the same round table as
:func:`build_table_plain` in the int32 table itself (a round's proposals
carry a tag bit until they commit) over worklists of the rows still
unplaced; on a CPU tensor it runs the plain version. The TPU kernel it replaces inserted rows one at a time, and
its table may differ from the round table where rows collide; probing
either gives the same join, so the port keeps the round table, which
parallelises over rows.
"""

from __future__ import annotations

import torch

from trino_tpu_torch import _kernels
from trino_tpu_torch.ops.join import MISSING, expand_matches, probe_join

# vacant-slot sentinel: int32 max, equal to join.MISSING — row ids are
# always below the capacity, so no live entry collides with it
EMPTY = 2**31 - 1

# static displacement window: the longest open-addressing chain per slot
# base. Capacity growth thins hash clusters past it; duplicate-key chains
# longer than this demote the site to the sort tier.
PROBE_WINDOW = 16


def slot_base_hash(key_hash: torch.Tensor, capacity: int) -> torch.Tensor:
    """Dense tier: table slot base from the mix64 key hash (the low bits,
    the same on int64 as on the reference's uint64)."""
    return (key_hash & (capacity - 1)).to(torch.int32)


def slot_base_binned(key: torch.Tensor, kmin, capacity: int) -> torch.Tensor:
    """Matmul tier: identity binning ``key - kmin`` onto the table —
    collision-free while the key domain fits the capacity; wider domains
    wrap and degrade to ordinary probing."""
    return ((key.to(torch.int64) - kmin) & (capacity - 1)).to(torch.int32)


def build_table_plain(
    slot_base: torch.Tensor,
    use: torch.Tensor,
    capacity: int,
    window: int = PROBE_WINDOW,
):
    """The round build in plain PyTorch. Returns ``(table int32[capacity],
    unplaced int32 scalar)``: the count of live rows without a slot."""
    dev = slot_base.device
    window = min(window, capacity)
    n = slot_base.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    table = torch.full((capacity,), EMPTY, dtype=torch.int32, device=dev)
    placed = ~use
    for d in range(window):
        prop = ((slot_base.to(torch.int64) + d) & (capacity - 1))
        vacant = table[prop] == EMPTY
        cand = torch.where(~placed & vacant, ids, EMPTY)
        table.scatter_reduce_(0, prop, cand, "amin")
        placed = placed | (table[prop] == ids)
    return table, (~placed).sum().to(torch.int32)


def _check_build_inputs(slot_base, use, capacity: int, window: int) -> None:
    if slot_base.dtype != torch.int32 or slot_base.ndim != 1 or not slot_base.is_contiguous():
        raise ValueError("dense_join_build: slot_base must be a contiguous 1-D int32 tensor")
    if (
        use.dtype != torch.bool
        or use.shape != slot_base.shape
        or use.device != slot_base.device
        or not use.is_contiguous()
    ):
        raise ValueError(
            "dense_join_build: use must be a contiguous bool tensor shaped "
            "like slot_base, on the same device"
        )
    if capacity <= 0 or capacity & (capacity - 1) or capacity >= 1 << 31:
        raise ValueError(
            f"dense_join_build: capacity {capacity} is not a power of two below 2^31"
        )
    if window <= 0:
        raise ValueError("dense_join_build: window must be positive")


# proposals are tagged with bit 30 while the kernel runs: row ids stay below it
_MAX_CUDA_ROWS = (1 << 30) - 1
# the kernel's most slot buckets (kMaxBuckets): their counts, starts and
# cursors follow the worklist lengths in its int32 scratch
_MAX_BUCKETS = 4096


def build_table_cuda(slot_base, use, capacity: int, window: int):
    """Launch ``csrc/dense_join_build.cu`` on the current stream: the live
    rows compacted and ordered by slot bucket (a count, a scan and one or
    two scatters), round 0 in shared memory one bucket a block, then the
    later rounds over worklists in one cooperative launch: at most six
    launches, counted as one build. Returns
    ``(table, unplaced, lens)``: ``lens[d]`` int32 is the count of rows
    entering round ``d`` (``lens[0]`` the live rows, ``lens[window]`` the
    unplaced ones, of which ``unplaced`` is a 0-d view)."""
    dev = slot_base.device
    n = int(slot_base.shape[0])
    if n > _MAX_CUDA_ROWS:
        raise ValueError(f"dense_join_build: {n} build rows, the kernel takes {_MAX_CUDA_ROWS}")
    table = torch.empty(capacity, dtype=torch.int32, device=dev)
    work = torch.empty((2, max(n, 1), 2), dtype=torch.int32, device=dev)
    # worklist lengths, then the counts, starts and cursors of the buckets
    counts = torch.empty(window + 1 + 4 * _MAX_BUCKETS, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min((max(n, capacity // 4) + 255) // 256, sms * 8))
    fn = _kernels.entry("dense_join_build")
    rc = fn(
        slot_base.data_ptr(), use.data_ptr(), n, capacity, window,
        table.data_ptr(), work.data_ptr(), counts.data_ptr(), blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check("dense_join_build", rc)
    _kernels.LAUNCHES["dense_join_build"] += 1
    lens = counts[: window + 1]
    return table, lens[window], lens


def build_table_device(
    slot_base: torch.Tensor,
    use: torch.Tensor,
    capacity: int,
    window: int = PROBE_WINDOW,
):
    """Kernel K2: the round table of row ids and the count of live rows
    left unplaced, ``(table int32[capacity], unplaced int32 scalar)``.
    ``slot_base`` int32 (n,), ``use`` bool (n,). On a CUDA tensor this
    launches the kernel (or raises); on a CPU tensor it runs the plain
    version."""
    window = min(window, capacity)
    _check_build_inputs(slot_base, use, capacity, window)
    if slot_base.device.type == "cuda":
        return build_table_cuda(slot_base, use, capacity, window)[:2]
    if slot_base.device.type != "cpu":
        raise ValueError(f"dense_join_build: unsupported device {slot_base.device}")
    _kernels.PLAIN_CALLS["dense_join_build"] += 1
    return build_table_plain(slot_base, use, capacity, window)


def build_table(
    slot_base: torch.Tensor,
    valid: torch.Tensor,
    sel: torch.Tensor,
    capacity: int,
    window: int = PROBE_WINDOW,
):
    """Insert the live build rows into an open-addressing table of row ids.

    Returns ``(table int32[capacity], overflow bool scalar)`` — ``overflow``
    set when any live row failed to place within ``window`` rounds (the
    executor re-hashes at doubled capacity)."""
    table, unplaced = build_table_device(
        slot_base.contiguous(), (valid & sel).contiguous(), capacity, window
    )
    return table, unplaced > 0


def probe_table(
    table: torch.Tensor,
    build_hash: torch.Tensor,
    probe_base: torch.Tensor,
    probe_hash: torch.Tensor,
    probe_valid: torch.Tensor,
    probe_sel: torch.Tensor,
    out_capacity,
    join_type: str = "inner",
    window: int = PROBE_WINDOW,
):
    """Expand probe x table matches into fixed-capacity gather indices.

    Same contract as ``join.probe_join`` (``out_capacity`` None sizes the
    output to the matches): ``(probe_pos, build_pos,
    out_sel, total, overflow)`` with ``build_pos == MISSING`` for outer
    rows; the caller runs ``verify_equal`` for hash-collision exactness.
    """
    capacity = table.shape[0]
    window = min(window, capacity)
    use = probe_valid & probe_sel
    if probe_hash.shape[0] == 0 or build_hash.shape[0] == 0:
        # statically empty side: the sort tier's guards cover it, LEFT
        # over an empty build included
        dev = probe_hash.device
        return probe_join(
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            probe_hash, probe_valid, probe_sel, out_capacity, join_type,
        )
    nb = build_hash.shape[0]
    mask = capacity - 1
    base64 = probe_base.to(torch.int64)

    def matches(base, phash, puse, d):
        e = table[(base + d) & mask]
        eh = build_hash[torch.clamp(e, 0, nb - 1).long()]
        return e, (e != EMPTY) & (eh == phash) & puse

    counts = torch.zeros(probe_hash.shape[0], dtype=torch.int64,
                         device=probe_hash.device)
    for d in range(window):
        counts += matches(base64, probe_hash, use, d)[1]
    probe_pos, j, out_sel, total, overflow = expand_matches(
        counts, probe_sel, out_capacity, join_type
    )
    # second W-round pass: per output slot, the j-th matching window entry
    # of its probe row ((out_capacity,)-sized arrays only; the (n, W) match
    # matrix is never materialized)
    ppos = probe_pos.long()
    o_base, o_hash, o_use = base64[ppos], probe_hash[ppos], use[ppos]
    build_pos = torch.full(out_sel.shape, MISSING, dtype=torch.int32,
                           device=table.device)
    r = torch.zeros_like(j)
    for d in range(window):
        e, m = matches(o_base, o_hash, o_use, d)
        build_pos = torch.where(m & (r == j), e, build_pos)
        r += m
    return probe_pos, build_pos, out_sel, total, overflow


def matmul_join_counts(
    probe_bins: torch.Tensor,
    build_bins: torch.Tensor,
    probe_use: torch.Tensor,
    build_use: torch.Tensor,
    domain: int,
    chunk: int = 2048,
) -> torch.Tensor:
    """Per-probe match counts as a contraction (reference:
    ``matmul_join_counts``): ``counts[i] = sum_g 1[probe_bin_i = g] *
    hist_g``, computed as one ``onehot @ hist`` product per ``chunk``
    probe rows, where ``hist`` counts the live build rows per bin. Equal to
    the gather ``hist[probe_bins]`` on live probe rows, 0 elsewhere; the
    join tier uses the gather, and this form stands for the join-project
    shapes of the benchmarks. int32 counts."""
    dev = probe_bins.device
    hist = torch.zeros(domain, dtype=torch.float32, device=dev)
    hist.index_add_(
        0, torch.where(build_use, build_bins, domain - 1).long(),
        build_use.to(torch.float32),
    )
    g = torch.arange(domain, dtype=probe_bins.dtype, device=dev)
    out = torch.empty(probe_bins.shape[0], dtype=torch.float32, device=dev)
    for lo in range(0, probe_bins.shape[0], chunk):
        b = probe_bins[lo : lo + chunk]
        u = probe_use[lo : lo + chunk]
        onehot = ((b[:, None] == g[None, :]) & u[:, None]).to(torch.float32)
        out[lo : lo + chunk] = onehot @ hist
    return out.to(torch.int32)
