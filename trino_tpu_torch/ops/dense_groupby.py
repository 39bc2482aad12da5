"""Dense-domain group-by: exact per-(bin, lane) totals in one kernel.

The reference's ``BigintGroupByHash.java`` is the single-int-key fast
path of its hash aggregation; for a SMALL key domain (G bins) no hashing
is needed at all: every (bin, aggregate-limb) partial sum is one cell of
the limb-total matrix

    lt[(bin >> 7) * lanes + lane, bin & 127] = sum over live rows r in bin
                                               of limb_lane(r)

Values are decomposed into 8-bit limbs (plus a negative-row-count lane per
signed 128-bit column and a row-count lane), so the totals reconstruct
exact sums of ANY width on the host or the device — including the 128-bit
DECIMAL accumulators.

Counterpart of ``trino_tpu/ops/dense_groupby.py``. The TPU kernel built
the matrix with a bf16 one-hot matmul and drained f32 accumulators into
int32 (hi, lo) pairs; here the CUDA kernel ``csrc/dense_groupby.cu`` adds
integers into per-block shared-memory copies of the table and flushes
them into the totals ``lt`` (``hi * 65536 + lo`` of the reference).
:func:`k1_launch_plan` decides how the table is cut for the card: live
lanes into slices that fit one block's shared memory, slices into launch
groups whose descriptor fits a kernel parameter, the per-warp copies and
the rows between flushes. :func:`dense_groupby_plain` is the same function
in plain PyTorch: the wrapper runs it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch import _kernels

# lane word codes (what an accumulator lane reads per row)
_W_ZERO = 60
_W_COUNT = 61
_W_SIGN_BASE = 100  # +ci: sign bit of column ci

# lane ops understood by csrc/dense_groupby.cu (0..56 = limb bit shift)
_OP_SIGN = 64
_OP_COUNT = 65
_OP_ZERO = 66

# launch geometry shared with csrc/dense_groupby.cu (kThreads, kMax*)
K1_THREADS = 1024
K1_TILE_ROWS = 4 * K1_THREADS       # one int4 of bins per thread
SMEM_BLOCK_BYTES = 232448           # opt-in shared memory of one H100 block
MAX_FLUSH_ROWS = 1 << 24            # 2^24 rows x 255 stays below 2^32
K1_MAX_COLS = 32                    # value columns of one launch group
K1_MAX_LANES = 704                  # lanes of one launch group
K1_MAX_SLICES = 32                  # slices of one launch group


@dataclasses.dataclass(frozen=True)
class DenseCol:
    """One int64-valued aggregate input column."""

    nonneg: bool       # True when column min >= 0 (skip high zero limbs)
    bits: int          # value bit-width needed (<= 64)

    @property
    def limbs(self) -> int:
        if not self.nonneg:
            return 8
        return max(1, (self.bits + 7) // 8)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Static lane layout for one dense group-by program.

    ``pair128[ci]`` — the column's sums are consumed as exact 128-bit
    (hi, lo) accumulators (a ``sum128`` spec reads it), REGARDLESS of the
    data's sign; a negative-count lane is added only when the data can
    actually be negative (two's-complement bias correction)."""

    G: int             # padded bin count (multiple of 128)
    cols: tuple        # DenseCol per distinct input column
    pair128: tuple     # per column: emit exact 128-bit (hi, lo) sums

    def sign_lane(self, ci: int) -> bool:
        return self.pair128[ci] and not self.cols[ci].nonneg

    def lane_tables(self):
        """(word_code, shift_bytes) per accumulator lane."""
        codes, shifts = [], []
        for ci, col in enumerate(self.cols):
            for j in range(col.limbs):
                codes.append(2 * ci + (0 if j < 4 else 1))
                shifts.append((j % 4) * 8)
            if self.sign_lane(ci):
                codes.append(_W_SIGN_BASE + ci)
                shifts.append(0)
        codes.append(_W_COUNT)
        shifts.append(0)
        while len(codes) % 8:
            codes.append(_W_ZERO)
            shifts.append(0)
        return codes, shifts

    @property
    def lanes(self) -> int:
        return len(self.lane_tables()[0])

    @property
    def tiles(self) -> int:
        return self.G // 128

    @property
    def m(self) -> int:
        return self.tiles * self.lanes


def lane_ops(plan: DensePlan) -> tuple[list[int], list[int]]:
    """Per lane: (column read, op) — the lane tables as the CUDA kernel
    takes them: op 0..56 is the bit shift of a limb of the full 64-bit
    value (limb j of a column shifts by 8j), then the column's sign lane,
    then the count lane and zero padding, in :meth:`DensePlan.lane_tables`
    order. Built from the columns, not by decoding the word codes, which
    collide from the 30th column on (code 2*30 is ``_W_ZERO``)."""
    cols, ops = [], []
    for ci, col in enumerate(plan.cols):
        for j in range(col.limbs):
            cols.append(ci)
            ops.append(8 * j)
        if plan.sign_lane(ci):
            cols.append(ci)
            ops.append(_OP_SIGN)
    cols.append(-1)
    ops.append(_OP_COUNT)
    while len(ops) % 8:
        cols.append(-1)
        ops.append(_OP_ZERO)
    return cols, ops


def _check_inputs(plan: DensePlan, bins, value_cols) -> None:
    if bins.dtype != torch.int32 or bins.ndim != 1 or not bins.is_contiguous():
        raise ValueError("dense_groupby: bins must be a contiguous 1-D int32 tensor")
    for v in value_cols:
        if (
            v.dtype != torch.int64
            or v.shape != bins.shape
            or v.device != bins.device
            or not v.is_contiguous()
        ):
            raise ValueError(
                "dense_groupby: value columns must be contiguous int64 "
                "tensors shaped like bins, on the same device"
            )
    if len(value_cols) != len(plan.cols):
        raise ValueError("dense_groupby: one value column per plan column")
    if plan.G % 128 or plan.G <= 0:
        raise ValueError("dense_groupby: G must be a positive multiple of 128")


def dense_groupby_plain(plan: DensePlan, bins, value_cols) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``index_add_`` of every
    lane's limb values over the (bin, lane) cells. Returns ``lt`` int64
    (M, 128); dead rows (``bin`` outside [0, G)) add nothing."""
    M, lanes = plan.m, plan.lanes
    live = (bins >= 0) & (bins < plan.G)
    b = torch.where(live, bins, 0).to(torch.int64)
    # flat cell of lane 0; dead rows go to one spare cell past the end
    base = torch.where(live, (b >> 7) * (lanes * 128) + (b & 127), M * 128)
    flat = torch.zeros(M * 128 + 1, dtype=torch.int64, device=bins.device)
    cols, ops = lane_ops(plan)
    for lane, (ci, op) in enumerate(zip(cols, ops)):
        if op == _OP_ZERO:
            continue
        if op == _OP_COUNT:
            add = torch.ones_like(b)
        elif op == _OP_SIGN:
            add = (value_cols[ci] < 0).to(torch.int64)
        else:
            add = (value_cols[ci] >> op) & 255
        idx = torch.where(live, base + lane * 128, M * 128)
        flat.index_add_(0, idx, add)
    return flat[: M * 128].reshape(M, 128)


@dataclasses.dataclass(frozen=True)
class K1Group:
    """Slices launched together as one grid: ``slices[s]`` lists the ``lt``
    lanes that the blocks with ``blockIdx.y == s`` hold in shared memory;
    ``cols`` are the plan columns those lanes read, in descriptor order."""

    slices: tuple
    cols: tuple
    blocks: int        # blocks per slice (gridDim.x)


@dataclasses.dataclass(frozen=True)
class K1Launch:
    """How :func:`dense_groupby_cuda` cuts one plan for the card."""

    groups: tuple      # K1Group per grid, launched in order
    copies: int        # shared-memory copies of a slice per block
    max_lanes: int     # most lanes in one slice
    smem_bytes: int    # dynamic shared memory of one block
    rows_per_flush: int

    @property
    def slices(self) -> tuple:
        return tuple(sl for g in self.groups for sl in g.slices)


def _split(lanes: list, parts: int) -> list:
    """``lanes`` cut into ``parts`` contiguous runs of near-equal length."""
    q, r = divmod(len(lanes), parts)
    out, at = [], 0
    for i in range(parts):
        k = q + (i < r)
        out.append(tuple(lanes[at:at + k]))
        at += k
    return out


@functools.lru_cache(maxsize=64)
def k1_launch_plan(plan: DensePlan, sms: int, n: int, blocks: int | None = None) -> K1Launch:
    """The launch plan of kernel K1 for ``plan`` over ``n`` rows on a card
    with ``sms`` multiprocessors.

    Only live lanes (limbs, sign lanes, the count) get shared memory: each
    is ``G`` uint32 counters. The live lanes are cut into the fewest
    near-equal contiguous slices whose counters fit one block and whose
    columns fit one descriptor; a block holds one slice. Slices are
    grouped, in order, into grids whose descriptor (lane words, column
    pointers, slice bounds) fits the kernel-parameter struct. Each block
    keeps ``copies`` copies of its slice, one per group of warps, the most
    (a power of two, up to one a warp) that fit its shared memory, so that
    warps adding to the same hot cell do not wait on each other. A grid
    has about one block per multiprocessor (``blocks`` per slice unless
    given), never more than there are tiles of rows."""
    cols, ops = lane_ops(plan)
    live = [l for l, op in enumerate(ops) if op != _OP_ZERO]
    lane_bytes = 4 * plan.G
    cap = min(SMEM_BLOCK_BYTES // lane_bytes, K1_MAX_LANES)
    if cap < 1:
        raise ValueError(f"dense_groupby: G={plan.G} leaves no lane in shared memory")

    def read(slices):
        """The value columns that the lanes of ``slices`` read."""
        return {cols[l] for sl in slices for l in sl if ops[l] != _OP_COUNT}

    parts = -(-len(live) // cap)
    while True:
        slices = _split(live, parts)
        if all(len(read([sl])) <= K1_MAX_COLS for sl in slices):
            break
        parts += 1
    max_lanes = max(len(sl) for sl in slices)
    copies = 1
    while copies * 2 <= K1_THREADS // 32 and 2 * copies * max_lanes * lane_bytes <= SMEM_BLOCK_BYTES:
        copies *= 2
    tiles = max(1, -(-n // K1_TILE_ROWS))
    groups, cur = [], []

    def close():
        per = blocks if blocks is not None else max(1, sms // len(cur))
        groups.append(K1Group(tuple(cur), tuple(sorted(read(cur))), max(1, min(per, tiles))))

    for sl in slices:
        nxt = cur + [sl]
        if cur and (
            len(nxt) > K1_MAX_SLICES
            or sum(map(len, nxt)) > K1_MAX_LANES
            or len(read(nxt)) > K1_MAX_COLS
        ):
            close()
            nxt = [sl]
        cur = nxt
    close()
    return K1Launch(
        groups=tuple(groups), copies=copies, max_lanes=max_lanes,
        smem_bytes=copies * max_lanes * lane_bytes,
        rows_per_flush=MAX_FLUSH_ROWS // K1_TILE_ROWS * K1_TILE_ROWS,
    )


class _K1Desc(ctypes.Structure):
    """``K1Desc`` of csrc/dense_groupby.cu, passed to the kernel by value."""

    _fields_ = [
        ("cols", ctypes.c_void_p * K1_MAX_COLS),
        # lt lane | op << 16 | descriptor column << 24
        ("lane", ctypes.c_uint32 * K1_MAX_LANES),
        ("slice_begin", ctypes.c_int32 * (K1_MAX_SLICES + 1)),
        ("nslices", ctypes.c_int32),
        ("max_lanes", ctypes.c_int32),
        ("copies", ctypes.c_int32),
        ("blocks", ctypes.c_int32),
    ]


def k1_descriptors(plan: DensePlan, launch: K1Launch, col_ptrs: Sequence[int]):
    """The launch groups of ``launch`` as a ctypes array of ``K1Desc``."""
    cols, ops = lane_ops(plan)
    descs = (_K1Desc * len(launch.groups))()
    for d, g in zip(descs, launch.groups):
        slot = {c: i for i, c in enumerate(g.cols)}
        for i, c in enumerate(g.cols):
            d.cols[i] = col_ptrs[c]
        j = 0
        for s, sl in enumerate(g.slices):
            d.slice_begin[s] = j
            for l in sl:
                d.lane[j] = l | ops[l] << 16 | slot.get(cols[l], 0) << 24
                j += 1
        d.slice_begin[len(g.slices)] = j
        d.nslices = len(g.slices)
        d.max_lanes = launch.max_lanes
        d.copies = launch.copies
        d.blocks = g.blocks
    return descs


def dense_groupby_cuda(plan: DensePlan, bins, value_cols, blocks: int | None = None) -> torch.Tensor:
    """Launch ``csrc/dense_groupby.cu`` on the current stream: one grid per
    launch group of :func:`k1_launch_plan` (one for every plan of the main
    path), counted as one launch. ``blocks`` fixes the blocks per slice."""
    dev = bins.device
    n = int(bins.shape[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = k1_launch_plan(plan, sms, n, blocks)
    lt = torch.zeros((plan.m, 128), dtype=torch.int64, device=dev)
    descs = k1_descriptors(plan, launch, [v.data_ptr() for v in value_cols])
    fn = _kernels.entry("dense_groupby")
    rc = fn(
        bins.data_ptr(), n, plan.G, plan.lanes, ctypes.byref(descs),
        len(descs), ctypes.sizeof(_K1Desc), launch.rows_per_flush,
        lt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check("dense_groupby", rc)
    _kernels.LAUNCHES["dense_groupby"] += 1
    return lt


def dense_groupby_device(
    plan: DensePlan,
    bins: torch.Tensor,
    value_cols: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Exact limb totals ``lt`` int64 (M, 128), row ``t * lanes + lane``,
    column ``bin & 127``. ``bins`` int32 (ncap,) in [0, G] with G = dead
    row; ``value_cols`` int64 (ncap,) each. On a CUDA tensor this launches
    the kernel (or raises); on a CPU tensor it runs the plain version."""
    value_cols = list(value_cols)
    _check_inputs(plan, bins, value_cols)
    if bins.device.type == "cuda":
        return dense_groupby_cuda(plan, bins, value_cols)
    if bins.device.type != "cpu":
        raise ValueError(f"dense_groupby: unsupported device {bins.device}")
    _kernels.PLAIN_CALLS["dense_groupby"] += 1
    return dense_groupby_plain(plan, bins, value_cols)


def reconstruct_device(plan: DensePlan, lt, kmins, kstrides, kranges):
    """Reconstruction on the limb totals' device.

    Returns (key_vals: list of (G,) int64 per key, col_sums: per column
    (G,) int64 modular sums or (G, 2) (hi, lo) 128-bit pairs, counts
    (G,) int64)."""
    from trino_tpu_torch.ops.decimal128 import add128

    T, LANES, G = plan.tiles, plan.lanes, plan.G
    lt = lt.reshape(T, LANES, 128)
    lane = 0
    col_sums: list = []
    for ci, col in enumerate(plan.cols):
        if plan.pair128[ci]:
            acc_hi = torch.zeros(G, dtype=torch.int64, device=lt.device)
            acc_lo = torch.zeros(G, dtype=torch.int64, device=lt.device)
            for j in range(col.limbs):
                c = lt[:, lane, :].reshape(G)  # < 2^48, non-negative
                sh = 8 * j
                c_lo = c << sh  # int64 wraps: the LOW 64 bits of c*2^sh
                # c >= 0, so the arithmetic shift is the logical one
                c_hi = c >> (64 - sh) if sh > 0 else torch.zeros_like(c)
                acc_hi, acc_lo = add128(acc_hi, acc_lo, c_hi, c_lo)
                lane += 1
            if plan.sign_lane(ci):
                neg = lt[:, lane, :].reshape(G)
                lane += 1
                # two's-complement bias per negative row
                acc_hi = acc_hi - neg
            col_sums.append(torch.stack([acc_hi, acc_lo], dim=1))
            continue
        acc = torch.zeros(G, dtype=torch.int64, device=lt.device)
        for j in range(col.limbs):
            acc = acc + (lt[:, lane, :].reshape(G) << (8 * j))
            lane += 1
        col_sums.append(acc)
    counts = lt[:, lane, :].reshape(G)
    b = torch.arange(G, dtype=torch.int64, device=lt.device)
    key_vals = [
        kmins[i] + torch.div(b, kstrides[i], rounding_mode="floor") % kranges[i]
        for i in range(kmins.shape[0])
    ]
    return key_vals, col_sums, counts


def reconstruct(plan: DensePlan, lt):
    """Host-side exact reconstruction: per bin, per column, the TRUE
    integer sum (python ints, any width) plus the group counts.

    Returns (sums: list per column of length-G list[int], counts:
    np.int64[G])."""
    if isinstance(lt, torch.Tensor):
        lt = lt.cpu().numpy()
    lt = np.asarray(lt).astype(np.int64)
    T, LANES, G = plan.tiles, plan.lanes, plan.G
    lt = lt.reshape(T, LANES, 128)
    lane = 0
    sums: list = []
    for ci, col in enumerate(plan.cols):
        if plan.pair128[ci] and not col.nonneg:
            # exact signed sum of ANY width (128-bit DECIMAL
            # accumulators): python-int math over G bins only
            acc = np.zeros((T, 128), object)
            for j in range(col.limbs):
                acc = acc + lt[:, lane, :].astype(object) * (1 << (8 * j))
                lane += 1
            neg = lt[:, lane, :]
            lane += 1
            flat = acc.reshape(G) - neg.reshape(G).astype(object) * (1 << 64)
            sums.append([int(x) for x in flat])
            continue
        if plan.pair128[ci]:
            # nonneg pair128: exact big-int (no sign lane present)
            acc = np.zeros((T, 128), object)
            for j in range(col.limbs):
                acc = acc + lt[:, lane, :].astype(object) * (1 << (8 * j))
                lane += 1
            sums.append([int(x) for x in acc.reshape(G)])
            continue
        # modular int64 semantics: vectorized uint64 wrap (what plain
        # BIGINT sums need; for nonneg columns the result is exact)
        acc = np.zeros((T, 128), np.uint64)
        for j in range(col.limbs):
            acc = acc + (
                lt[:, lane, :].astype(np.uint64) << np.uint64(8 * j)
            )
            lane += 1
        sums.append(acc.reshape(G).view(np.int64).tolist())
    counts = lt[:, lane, :].reshape(G).astype(np.int64)
    return sums, counts
