"""Civil-date integer math (Hinnant's algorithms), host side.

The analyzer folds DATE literals and ``date_add_months`` constants with
these; both are plain integer arithmetic over Python ints or numpy
arrays, so the planner never touches a device.
"""

from __future__ import annotations

import numpy as np


def civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), elementwise over an
    integer numpy array (floor division throughout, as the algorithm
    requires for dates before the epoch)."""
    z = np.asarray(days, dtype=np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = np.floor_divide(doe - doe // 1460 + doe // 36524 - doe // 146096, 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = np.floor_divide(5 * doy + 2, 153)
    d = doy - np.floor_divide(153 * mp + 2, 5) + 1
    m = mp + np.where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """(year, month, day) -> days since 1970-01-01 (date literals)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468
