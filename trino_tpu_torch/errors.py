"""Shared error classification for /v1/query info and query events.

Reference: ``spi/StandardErrorCode.java`` — every failure maps to a
stable (code, name, type) triple so clients and event listeners can
branch on class (USER_ERROR vs INTERNAL_ERROR vs
INSUFFICIENT_RESOURCES) without string-matching messages. Lives at the
top of the package (not under ``server/``) because both the engine's
event firing and the server's ManagedQuery need it without creating an
engine ↔ server import cycle.
"""

from __future__ import annotations

from typing import Tuple

GENERIC_INTERNAL_ERROR = (65536, "GENERIC_INTERNAL_ERROR", "INTERNAL_ERROR")


def classify_error(e: BaseException) -> Tuple[int, str, str]:
    """Map an exception to its (error_code, error_name, error_type).

    Imports are deferred: classification happens once per failed query,
    and the analyzer/planner modules this touches are heavyweight.
    """
    from trino_tpu_torch.analyzer import SemanticError
    from trino_tpu_torch.memory import ExceededMemoryLimitError
    from trino_tpu_torch.obs.history import HistoryHbmRejected
    from trino_tpu_torch.planner.sanity import PlanValidationError
    from trino_tpu_torch.sql.lexer import SqlSyntaxError

    if isinstance(e, HistoryHbmRejected):
        # the admission gate rejected the query: its fingerprint's
        # observed peak device bytes cannot fit the card
        return (131075, "EXCEEDED_MEMORY_LIMIT", "INSUFFICIENT_RESOURCES")
    if isinstance(e, SqlSyntaxError):
        return (1, "SYNTAX_ERROR", "USER_ERROR")
    if isinstance(e, SemanticError):
        return (2, "SEMANTIC_ERROR", "USER_ERROR")
    if isinstance(e, PlanValidationError):
        # a sanity checker rejected the plan: an engine bug, not a
        # user error — name the checker in the /v1/query error
        return (65537, "PLAN_VALIDATION_ERROR", "INTERNAL_ERROR")
    if isinstance(e, ExceededMemoryLimitError):
        return (131075, "EXCEEDED_MEMORY_LIMIT", "INSUFFICIENT_RESOURCES")
    if isinstance(e, KeyError):
        return (2, "SEMANTIC_ERROR", "USER_ERROR")
    return GENERIC_INTERNAL_ERROR
