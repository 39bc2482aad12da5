"""Helpers of the port's cluster tests (``tests/test_torch_cluster*.py``,
``test_torch_fault_tolerance.py``, ``test_torch_scaled_writers.py``):
reads of a cluster's HTTP documents with the internal credential, as a
cluster peer sends them. Not a test file."""

from __future__ import annotations

import json
import urllib.error
import urllib.request


def get_json(uri: str, path: str, timeout: float = 30.0):
    from trino_tpu_torch.server import auth

    req = urllib.request.Request(f"{uri}{path}", headers=auth.headers())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def get_text(uri: str, path: str, timeout: float = 30.0) -> str:
    from trino_tpu_torch.server import auth

    req = urllib.request.Request(f"{uri}{path}", headers=auth.headers())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def query_infos(cluster) -> list[dict]:
    """The coordinator's query listing (``/v1/query``)."""
    return get_json(cluster.coordinator_uri, "/v1/query")


def query_info_for(cluster, marker: str) -> dict:
    """The newest query whose text holds ``marker``, as ``/v1/query``
    lists it (the listing is not in submission order: the latest
    ``createTime`` wins)."""
    qs = [q for q in query_infos(cluster) if marker in q["query"]]
    assert qs, f"no query matching {marker!r} on the coordinator"
    return max(qs, key=lambda q: q.get("createTime") or 0)


def query_id_for(cluster, marker: str) -> str:
    return query_info_for(cluster, marker)["queryId"]


def execute_with_id(cluster, sql: str, session_properties=None):
    """``cluster.execute`` that also returns the statement's query id, as
    the coordinator's first response names it: ``(rows, names, id)``."""
    from trino_tpu_torch.client import ClientSession, StatementClient

    cs = ClientSession(
        properties={"execution_mode": "cluster", **(session_properties or {})}
    )
    client = StatementClient(cluster.coordinator_uri, sql, cs)
    rows = list(client.rows())
    names = [c.name for c in client.columns] if client.columns else []
    return rows, names, client.query_id


def query_info_by_id(cluster, query_id: str) -> dict:
    """The coordinator's listing entry of one query (``/v1/query``)."""
    qs = [q for q in query_infos(cluster) if q["queryId"] == query_id]
    assert qs, f"no query {query_id} on the coordinator"
    return qs[0]


def worker_tasks(cluster) -> dict[str, dict]:
    """Every live worker's task listing by task id (a killed worker's
    tasks are gone with it)."""
    out: dict[str, dict] = {}
    for uri in cluster.worker_uris:
        try:
            for t in get_json(uri, "/v1/task", timeout=10):
                out[t["taskId"]] = t
        except OSError:
            continue
    return out


def cluster_timeline(cluster, qid: str) -> list:
    """Union of the coordinator's and every worker's span dump for one
    trace — the cross-process view a real backend would assemble."""
    spans = list(get_json(cluster.coordinator_uri, f"/v1/query/{qid}/timeline")["spans"])
    for uri in cluster.worker_uris:
        try:
            spans.extend(get_json(uri, f"/v1/query/{qid}/timeline")["spans"])
        except (urllib.error.HTTPError, OSError):
            pass  # worker saw no tasks for this query
    return spans
