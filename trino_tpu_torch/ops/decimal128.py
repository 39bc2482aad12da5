"""128-bit integer helpers: signed (hi, lo) int64 pairs.

The subset of ``trino_tpu/ops/decimal128.py`` this engine needs today:
the (hi, lo) pair to Python int conversion, and the exact
two's-complement 128-bit add used by the dense group-by reconstruction.

No uint64 on the device: torch has no unsigned 64-bit shift, compare or
scatter-min on every backend, so unsigned order is the signed order of
values with their sign bit flipped, and int64 add/multiply wrap exactly
as uint64 does.
"""

from __future__ import annotations

_TWO64 = 1 << 64
_TWO127 = 1 << 127
_TWO128 = 1 << 128
_SIGNBIT = -(1 << 63)


def pair_to_int(hi: int, lo: int) -> int:
    """(hi, lo) int64 scalars -> Python int (signed 128-bit)."""
    u = ((int(hi) & 0xFFFFFFFFFFFFFFFF) << 64) | (int(lo) & 0xFFFFFFFFFFFFFFFF)
    return u - _TWO128 if u >= _TWO127 else u


def is_wide_data(data) -> bool:
    return getattr(data, "ndim", 1) == 2


def add128(hi1, lo1, hi2, lo2):
    """(hi, lo) + (hi, lo) in two's complement with carry, on int64
    tensors: the low words add modulo 2^64 and carry when the unsigned
    sum is below an addend."""
    lo = lo1 + lo2
    carry = ((lo ^ _SIGNBIT) < (lo1 ^ _SIGNBIT)).to(lo.dtype)
    return hi1 + hi2 + carry, lo
