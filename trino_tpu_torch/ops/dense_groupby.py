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
integers with 64-bit atomics and returns the totals ``lt`` directly
(``hi * 65536 + lo`` of the reference). :func:`dense_groupby_plain` is the
same function in plain PyTorch: the wrapper runs it for CPU tensors only.
"""

from __future__ import annotations

import dataclasses
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
    value (word code 2ci+1 reads the high word, so its shift is +32)."""
    cols, ops = [], []
    for code, shift in zip(*plan.lane_tables()):
        if code == _W_COUNT:
            cols.append(-1)
            ops.append(_OP_COUNT)
        elif code == _W_ZERO:
            cols.append(-1)
            ops.append(_OP_ZERO)
        elif code >= _W_SIGN_BASE:
            cols.append(code - _W_SIGN_BASE)
            ops.append(_OP_SIGN)
        else:
            cols.append(code // 2)
            ops.append(shift + 32 * (code % 2))
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


def dense_groupby_cuda(plan: DensePlan, bins, value_cols) -> torch.Tensor:
    """Launch ``csrc/dense_groupby.cu`` on the current stream."""
    dev = bins.device
    M = plan.m
    lt = torch.zeros((M, 128), dtype=torch.int64, device=dev)
    cols, ops = lane_ops(plan)
    lane_col = torch.tensor(cols, dtype=torch.int32, device=dev)
    lane_op = torch.tensor(ops, dtype=torch.int32, device=dev)
    ptrs = torch.tensor(
        [v.data_ptr() for v in value_cols] or [0], dtype=torch.int64, device=dev
    )
    n = int(bins.shape[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min((n + 255) // 256, sms * 8))
    fn = _kernels.entry("dense_groupby")
    rc = fn(
        bins.data_ptr(), ptrs.data_ptr(), lane_col.data_ptr(),
        lane_op.data_ptr(), plan.lanes, plan.G, n, lt.data_ptr(), blocks,
        torch.cuda.current_stream(dev).cuda_stream,
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
