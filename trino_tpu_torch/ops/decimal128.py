"""Int128 decimal arithmetic on int64 pairs.

Reference semantics: ``core/trino-spi/src/main/java/io/trino/spi/type/
UnscaledDecimal128Arithmetic.java``. Counterpart of
``trino_tpu/ops/decimal128.py``, with the same functions and results bit
for bit:

- A *wide* value is two int64 lanes ``(hi, lo)`` holding the two's
  complement 128-bit integer (``lo`` read unsigned). A wide column is an
  ``(n, 2)`` int64 tensor.
- Multiplication is the four-product 32-bit-limb schoolbook.
- SUM accumulates four unsigned 32-bit limbs per value as independent
  int64 sums (a limb lane sums 2^31 rows without overflowing) and
  resolves carries once per group.

No uint64 on the device: torch has no unsigned 64-bit shift, compare or
scatter-min on every backend, so a logical right shift masks the
arithmetic one, unsigned order is the signed order of values with their
sign bit flipped, and int64 add/multiply/left shift wrap exactly as
uint64 does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_TWO64 = 1 << 64
_TWO127 = 1 << 127
_TWO128 = 1 << 128
_SIGNBIT = -(1 << 63)  # int64 min as bit pattern


# --- scalar conversions (host) ----------------------------------------------


def int_to_pair(v: int) -> tuple[int, int]:
    """Python int -> (hi, lo) two's-complement int64 scalars."""
    u = v & (_TWO128 - 1)
    lo = u & 0xFFFFFFFFFFFFFFFF
    hi = u >> 64
    if lo >= 1 << 63:
        lo -= _TWO64
    if hi >= 1 << 63:
        hi -= _TWO64
    return hi, lo


def pair_to_int(hi: int, lo: int) -> int:
    """(hi, lo) int64 scalars -> Python int (signed 128-bit)."""
    u = ((int(hi) & 0xFFFFFFFFFFFFFFFF) << 64) | (int(lo) & 0xFFFFFFFFFFFFFFFF)
    return u - _TWO128 if u >= _TWO127 else u


def wide_from_ints(values: Sequence[int]) -> np.ndarray:
    """Python ints -> (n, 2) int64 wide column data."""
    out = np.empty((len(values), 2), dtype=np.int64)
    for i, v in enumerate(values):
        out[i, 0], out[i, 1] = int_to_pair(int(v))
    return out


def wide_to_ints(arr) -> list[int]:
    arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return [pair_to_int(arr[i, 0], arr[i, 1]) for i in range(arr.shape[0])]


def is_wide_data(data) -> bool:
    return getattr(data, "ndim", 1) == 2


# --- unsigned helpers on int64 lanes ----------------------------------------


def _srl(x, k: int):
    """Logical (unsigned) right shift of int64 lanes by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _ult(a, b):
    """Unsigned a < b over int64 lanes."""
    return (a ^ _SIGNBIT) < (b ^ _SIGNBIT)


# --- device kernels ---------------------------------------------------------


def mulhi_u64(a, b):
    """High 64 bits of the unsigned 64x64 product (32-bit limb schoolbook)."""
    a_lo, a_hi = a & _MASK32, _srl(a, 32)
    b_lo, b_hi = b & _MASK32, _srl(b, 32)
    p0 = a_lo * b_lo
    p1 = a_lo * b_hi
    p2 = a_hi * b_lo
    p3 = a_hi * b_hi
    cy = _srl(_srl(p0, 32) + (p1 & _MASK32) + (p2 & _MASK32), 32)
    return p3 + _srl(p1, 32) + _srl(p2, 32) + cy


def mul_i64_to_i128(a, b):
    """Signed 64x64 -> exact 128-bit product as (hi, lo) int64 lanes."""
    lo = a * b  # wrapping low 64
    # two's complement: hi_signed = hi_unsigned - (a<0 ? b : 0) - (b<0 ? a : 0)
    hi = mulhi_u64(a, b)
    hi = hi - torch.where(a < 0, b, torch.zeros_like(b))
    hi = hi - torch.where(b < 0, a, torch.zeros_like(a))
    return hi, lo


def mul_i64_overflows(a, b):
    """True where the signed 64x64 product does not fit int64."""
    hi, lo = mul_i64_to_i128(a, b)
    return hi != (lo >> 63)


def add128(hi1, lo1, hi2, lo2):
    """(hi, lo) + (hi, lo) in two's complement with carry: the low words
    add modulo 2^64 and carry when the unsigned sum is below an addend."""
    lo = lo1 + lo2
    carry = _ult(lo, lo1).to(lo.dtype)
    return hi1 + hi2 + carry, lo


def mul128_by_i64(hi, lo, m):
    """Low 128 bits of (hi, lo) * m (signed). Exact when the true product
    fits 128 bits (the caller's precision cap guarantees it)."""
    p_hi, p_lo = mul_i64_to_i128(lo, m)
    # lo is an unsigned limb that mul_i64_to_i128 read signed: add back
    # m << 64 where its sign bit was set
    p_hi = p_hi + torch.where(lo < 0, m, torch.zeros_like(m))
    return p_hi + hi * m, p_lo


def widen_i64(v):
    """int64 -> (hi, lo) sign-extended."""
    return v >> 63, v


def neg128(hi, lo):
    nlo = ~lo + 1
    carry = (nlo == 0).to(hi.dtype)
    return ~hi + carry, nlo


def compare128(hi1, lo1, hi2, lo2):
    """-1 / 0 / +1 int32 sign tensor of a signed 128-bit comparison."""
    hi_lt = hi1 < hi2
    hi_gt = hi1 > hi2
    lt = hi_lt | (~hi_gt & _ult(lo1, lo2))
    gt = hi_gt | (~hi_lt & _ult(lo2, lo1))
    out = torch.where(lt, -1, torch.where(gt, 1, 0))
    return out.to(torch.int32)


def sort_operands_wide(hi, lo, ascending: bool = True):
    """Sort keys realizing signed-128 order under ascending sorts:
    (hi signed, lo with its sign bit flipped so unsigned order is signed
    order)."""
    lo_key = lo ^ _SIGNBIT
    if not ascending:
        return [-1 - hi, -1 - lo_key]
    return [hi, lo_key]


# --- accumulation -----------------------------------------------------------


def _limbs32_from_i64(v):
    """int64 values -> two unsigned 32-bit limbs in int64 lanes."""
    return v & _MASK32, _srl(v, 32)


def narrow_limb_sums(data, weights_valid, seg_sum):
    """Per-group exact sums of int64 values via 32-bit limb accumulation.

    ``seg_sum(lanes) -> (G, k)`` reduces a list of k (n,) lanes per group
    (the caller owns the grouping: sorted segments in
    :mod:`ops.aggregation`, a plain sum for globals); the reference calls
    it lane by lane, here all lanes go in one call.

    Returns (G, 3) int64: [limb0_sum, limb1_sum, neg_count]; the true
    per-group sum = limb0 + limb1*2^32 - neg_count*2^64."""
    l0, l1 = _limbs32_from_i64(data)
    return seg_sum(_masked([l0, l1, (data < 0).to(data.dtype)], weights_valid))


def wide_limb_sums(hi, lo, weights_valid, seg_sum):
    """Per-group sums of (hi, lo) wide values as 5 limb columns:
    [lo0, lo1, hi0, hi1, hi_neg]; true sum = lo0 + lo1*2^32 +
    (hi0 + hi1*2^32 - hi_neg*2^64)*2^64. ``seg_sum`` as in
    :func:`narrow_limb_sums`."""
    lo0, lo1 = _limbs32_from_i64(lo)
    hi0, hi1 = _limbs32_from_i64(hi)
    lanes = [lo0, lo1, hi0, hi1, (hi < 0).to(lo.dtype)]
    return seg_sum(_masked(lanes, weights_valid))


def _masked(lanes, weights_valid):
    if weights_valid is None:  # no nulls: skip the masking
        return lanes
    return [torch.where(weights_valid, x, torch.zeros_like(x)) for x in lanes]


def _shl32_128(v):
    """int64 v << 32 as a 128-bit (hi, lo) pair."""
    return v >> 32, v << 32


def limb_sums_to_pair(limbs):
    """Reconstruction of limb sums into (hi, lo) lanes, on the device.

    Accepts the (G, 3) output of :func:`narrow_limb_sums` or the (G, 5)
    output of :func:`wide_limb_sums`. Exact mod 2^128; true DECIMAL(38)
    sums fit 127 bits."""
    if limbs.shape[1] == 3:
        s0, s1, sn = limbs[:, 0], limbs[:, 1], limbs[:, 2]
        hi, lo = widen_i64(s0)
        hi, lo = add128(hi, lo, *_shl32_128(s1))
        return hi - sn, lo
    lo0, lo1, hi0, hi1 = (limbs[:, i] for i in range(4))
    lp_hi, lp_lo = add128(*widen_i64(lo0), *_shl32_128(lo1))
    # the hi part hi0 + hi1<<32 - neg<<64 lands in the hi lane: only its
    # low 64 bits count, and neg<<64 has none
    _, hp_lo = add128(*widen_i64(hi0), *_shl32_128(hi1))
    return lp_hi + hp_lo, lp_lo


_NLIMB = 9  # 288 bits: |dividend| < 2^127 times 10^shift (shift <= 39)


def _limbs9_from_pair(hi, lo):
    """Non-negative (hi, lo) -> (n, 9) little-endian 32-bit limbs in int64
    lanes."""
    z = torch.zeros_like(lo)
    limbs = [lo & _MASK32, _srl(lo, 32), hi & _MASK32, _srl(hi, 32)]
    return torch.stack(limbs + [z] * (_NLIMB - 4), dim=1)


def _limbs_mul_small(limbs, m: int):
    """(n, k) limbs times a scalar < 2^31, with carry propagation. Returns
    (limbs, lost): ``lost`` marks rows whose product overflowed the limb
    width."""
    out = []
    carry = torch.zeros_like(limbs[:, 0])
    for j in range(limbs.shape[1]):
        prod = limbs[:, j] * m + carry
        out.append(prod & _MASK32)
        carry = prod >> 32
    return torch.stack(out, dim=1), carry != 0


def _limbs_scale10(limbs, digits: int):
    """Multiply a limb array by 10**digits in < 2^31 steps. Returns
    (limbs, lost)."""
    lost = torch.zeros(limbs.shape[0], dtype=torch.bool, device=limbs.device)
    while digits > 0:
        step = min(digits, 9)
        limbs, step_lost = _limbs_mul_small(limbs, 10**step)
        lost = lost | step_lost
        digits -= step
    return limbs, lost


def _uge128(ahi, alo, bhi, blo):
    """Unsigned (ahi, alo) >= (bhi, blo)."""
    return _ult(bhi, ahi) | ((ahi == bhi) & ~_ult(alo, blo))


def _sub128(ahi, alo, bhi, blo):
    lo = alo - blo
    borrow = _ult(alo, blo).to(ahi.dtype)
    return ahi - bhi - borrow, lo


def div128_round(ahi, alo, bhi, blo, shift: int):
    """Exact DECIMAL division with HALF_UP rounding:
    ``round(a * 10**shift / b)`` over signed 128-bit (hi, lo) pairs.

    Reference semantics: ``UnscaledDecimal128Arithmetic`` divideRoundUp —
    scale the dividend, divide magnitudes, round half away from zero,
    apply the sign. Division by zero, a scaled dividend past 288 bits, or
    a quotient of 2^127 or more give 0 with ``ok`` False (callers turn
    that into NULL).

    The magnitudes divide by restoring long division one dividend bit at
    a time. The remainder stays below the divisor's magnitude (at most
    2^127), so it lives in one unsigned (hi, lo) pair; the quotient in
    another, with a sticky flag for bits shifted past its top. The loop
    starts at the highest dividend bit set in any row (one host read):
    the bits above it only shift zeros.

    Returns (qhi, qlo, ok)."""
    sign_neg = (ahi < 0) ^ (bhi < 0)
    na_hi, na_lo = neg128(ahi, alo)
    abs_a_hi = torch.where(ahi < 0, na_hi, ahi)
    abs_a_lo = torch.where(ahi < 0, na_lo, alo)
    nb_hi, nb_lo = neg128(bhi, blo)
    den_hi = torch.where(bhi < 0, nb_hi, bhi)
    den_lo = torch.where(bhi < 0, nb_lo, blo)

    num = _limbs9_from_pair(abs_a_hi, abs_a_lo)
    ok = (den_hi != 0) | (den_lo != 0)
    if shift > 0:
        num, lost = _limbs_scale10(num, shift)
        ok = ok & ~lost
    n = num.shape[0]
    zero = torch.zeros_like(alo)
    rem_hi, rem_lo = zero, zero
    q_hi, q_lo = zero, zero
    q_lost = torch.zeros(n, dtype=torch.bool, device=alo.device)
    top = 0
    narrow_den = True
    from trino_tpu_torch.exec.programs import static_shapes

    if n and static_shapes():
        # inside a program no host read: the loop walks every bit a
        # dividend below 2^127 scaled by 10^shift can have
        top = min(32 * num.shape[1], 128 + (shift * 3322 + 999) // 1000)
        narrow_den = False
    elif n:
        # one host read: the limbs' maxima and whether every divisor
        # magnitude fits 63 bits
        den_fits = ((den_hi == 0) & (den_lo >= 0)).all().to(num.dtype).reshape(1)
        *maxima, narrow = torch.cat([num.amax(dim=0), den_fits]).tolist()
        narrow_den = bool(narrow)
        for j, m in enumerate(maxima):
            if m:
                top = 32 * j + int(m).bit_length()
    if top <= 62 and narrow_den:
        # every scaled dividend and divisor magnitude fits 63 bits: one
        # int64 division gives the same quotient and remainder as the
        # bit loop below
        a64 = num[:, 0] | (num[:, 1] << 32)
        d64 = torch.where(ok, den_lo, torch.ones_like(den_lo))
        q_lo = torch.div(a64, d64, rounding_mode="floor")
        rem_lo = a64 - q_lo * d64
        rem_hi = q_hi = zero
        top = 0
    for pos in range(top - 1, -1, -1):
        bit = (num[:, pos // 32] >> (pos % 32)) & 1
        rem_hi = (rem_hi << 1) | _srl(rem_lo, 63)
        rem_lo = (rem_lo << 1) | bit
        ge = _uge128(rem_hi, rem_lo, den_hi, den_lo)
        s_hi, s_lo = _sub128(rem_hi, rem_lo, den_hi, den_lo)
        rem_hi = torch.where(ge, s_hi, rem_hi)
        rem_lo = torch.where(ge, s_lo, rem_lo)
        q_lost = q_lost | (q_hi < 0)
        q_hi = (q_hi << 1) | _srl(q_lo, 63)
        q_lo = (q_lo << 1) | ge.to(q_lo.dtype)
    # HALF_UP: round away from zero when 2*rem >= den, i.e. rem >= den - rem
    h_hi, h_lo = _sub128(den_hi, den_lo, rem_hi, rem_lo)
    roundup = _uge128(rem_hi, rem_lo, h_hi, h_lo) & ok
    q_lo2 = q_lo + roundup.to(q_lo.dtype)
    carry = (roundup & (q_lo2 == 0)).to(q_hi.dtype)
    q_hi2 = q_hi + carry
    # the magnitude must stay below 2^127 before the sign is applied
    over = q_lost | ((q_hi == -1) & (carry == 1)) | (q_hi2 < 0)
    ok = ok & ~over
    nqhi, nqlo = neg128(q_hi2, q_lo2)
    qhi = torch.where(sign_neg, nqhi, q_hi2)
    qlo = torch.where(sign_neg, nqlo, q_lo2)
    qhi = torch.where(ok, qhi, zero)
    qlo = torch.where(ok, qlo, zero)
    return qhi, qlo, ok


def rescale_up_wide(hi, lo, digits: int):
    """Multiply a wide value by 10**digits (digits >= 0), exact while the
    true result fits 128 bits."""
    while digits > 0:
        step = min(digits, 18)
        hi, lo = mul128_by_i64(hi, lo, torch.full_like(lo, 10**step))
        digits -= step
    return hi, lo


def global_minmax_wide(hi, lo, use, kind: str):
    """min/max of (hi, lo) wide values over selected rows: the extreme of
    the signed hi lane, then the extreme of the unsigned lo lane among the
    rows tied on it. Returns (1,)-shaped (hi, lo)."""
    info = torch.iinfo(torch.int64)
    if kind == "max":
        ident, red = info.min, torch.amax
    else:
        ident, red = info.max, torch.amin
    best_hi = red(torch.where(use, hi, ident))
    tied = use & (hi == best_hi)
    best_lo_key = red(torch.where(tied, lo ^ _SIGNBIT, ident))
    return best_hi.reshape(1), (best_lo_key ^ _SIGNBIT).reshape(1)


def narrow_sums_to_ints(sums) -> list[int]:
    """Host reconstruction for :func:`narrow_limb_sums` output."""
    sums = sums.cpu().numpy() if isinstance(sums, torch.Tensor) else np.asarray(sums)
    return [
        int(s0) + (int(s1) << 32) - (int(sn) << 64) for s0, s1, sn in sums
    ]


def wide_sums_to_ints(sums) -> list[int]:
    """Host reconstruction for :func:`wide_limb_sums` output."""
    sums = sums.cpu().numpy() if isinstance(sums, torch.Tensor) else np.asarray(sums)
    out = []
    for lo0, lo1, hi0, hi1, neg in (map(int, r) for r in sums):
        lo_part = lo0 + (lo1 << 32)
        hi_part = hi0 + (hi1 << 32) - (neg << 64)
        out.append(lo_part + (hi_part << 64))
    return out
