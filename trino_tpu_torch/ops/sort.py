"""Sort-key descriptor shared by the planner and the sort operators.

Host-only: plan nodes carry a :class:`SortKey` per ORDER BY item, so the
planner can describe an ordering without importing any device code.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SortKey:
    ascending: bool = True
    nulls_first: bool = False  # Trino default: NULLS LAST for ASC
