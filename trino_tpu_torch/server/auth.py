"""Internal cluster authentication: shared-secret bearer token.

Reference: ``server/InternalAuthenticationManager.java`` +
``InternalCommunicationConfig.java:49`` — coordinator/worker RPC carries a
shared-secret credential so task, announce, discovery, and SPMD endpoints
reject outside callers. The secret rides the ``TRINO_TPU_INTERNAL_SECRET``
environment variable (every process of one cluster shares it); with no
secret configured, auth is disabled (single-process/dev mode).

A copy of ``trino_tpu/server/auth.py``. It guards the cluster tier's
internal paths (tasks, spool, scaled writes, discovery, announcements
and the SPMD phases).
"""

from __future__ import annotations

import os

ENV_VAR = "TRINO_TPU_INTERNAL_SECRET"

#: request paths that are cluster-internal (prefix match)
INTERNAL_PREFIXES = (
    "/v1/task", "/v1/announce", "/v1/spmd", "/v1/discovery", "/v1/write",
    "/v1/spool",
)


def secret() -> str | None:
    return os.environ.get(ENV_VAR) or None


def headers() -> dict[str, str]:
    s = secret()
    return {"Authorization": f"Bearer {s}"} if s else {}


def is_internal_path(path: str) -> bool:
    return any(path.startswith(p) for p in INTERNAL_PREFIXES)


def authorized(request_headers) -> bool:
    import hmac

    s = secret()
    if s is None:
        return True
    provided = request_headers.get("Authorization") or ""
    return hmac.compare_digest(provided, f"Bearer {s}")
