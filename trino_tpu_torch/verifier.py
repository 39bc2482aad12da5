"""Query verifier: replay a query corpus against two engines and diff.

Reference: ``service/trino-verifier`` — replays logged queries against a
control and a test cluster and reports result mismatches. Here the
control/test pair is any two of: a server URI (``http://...``), ``local``
(the in-process interpreter), or ``distributed`` (the program path) —
e.g. verifying the program path against the interpreter, or a new build
against a running server.

Usage:
    python -m trino_tpu_torch.verifier --control local --test distributed \
        --queries queries.sql [--max-rows 100000] [--device cpu]
Each statement in the file (``;``-separated) runs on both; rows are
compared as sorted multisets. The engines run on the card (``--device
cuda``, the default) unless ``--device cpu`` is given; without a GPU the
default raises instead of running on the host.
"""

from __future__ import annotations

import argparse
import sys
import time
from decimal import Decimal
from typing import Callable


def _runner_for(spec: str, device=None) -> Callable[[str], list[tuple]]:
    if spec.startswith("http://") or spec.startswith("https://"):
        from trino_tpu_torch.client import Connection

        conn = Connection(spec)
        return lambda sql: conn.execute(sql)[0]
    if spec == "local":
        from trino_tpu_torch.testing import LocalQueryRunner

        r = LocalQueryRunner(device=device)
        return lambda sql: r.execute(sql)[0]
    if spec == "distributed":
        from trino_tpu_torch.testing import DistributedQueryRunner

        r = DistributedQueryRunner(device=device)
        return lambda sql: r.execute(sql)[0]
    raise ValueError(f"unknown engine spec: {spec}")


def _normalize(rows: list[tuple]) -> list[tuple]:
    out = []
    for row in rows:
        out.append(
            tuple(
                float(v) if isinstance(v, Decimal) else v
                for v in row
            )
        )
    return sorted(out, key=repr)


def verify(
    control: str, test: str, queries: list[str], max_rows: int = 1_000_000,
    device=None,
) -> int:
    """Returns the number of mismatching queries (0 = success)."""
    run_c = _runner_for(control, device)
    run_t = _runner_for(test, device)
    failures = 0
    for i, sql in enumerate(queries):
        sql = sql.strip()
        if not sql:
            continue
        label = f"[{i + 1}/{len(queries)}]"
        try:
            t0 = time.time()
            rc = run_c(sql)
            tc = time.time() - t0
            t0 = time.time()
            rt = run_t(sql)
            tt = time.time() - t0
        except Exception as e:  # noqa: BLE001 — report and continue
            print(f"{label} ERROR: {e}\n  {sql[:120]}")
            failures += 1
            continue
        if len(rc) > max_rows or len(rt) > max_rows:
            print(f"{label} SKIP (too many rows): {sql[:80]}")
            continue
        nc, nt = _normalize(rc), _normalize(rt)
        if nc == nt:
            print(f"{label} OK   {len(rc):7d} rows  control {tc:5.2f}s test {tt:5.2f}s")
        else:
            failures += 1
            print(f"{label} MISMATCH ({len(nc)} vs {len(nt)} rows): {sql[:100]}")
            for a, b in list(zip(nc, nt))[:3]:
                if a != b:
                    print(f"    control: {a}\n    test:    {b}")
                    break
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu-verifier")
    ap.add_argument("--control", required=True, help="http://..., local, distributed")
    ap.add_argument("--test", required=True)
    ap.add_argument("--queries", required=True, help="file of ;-separated SQL")
    ap.add_argument("--max-rows", type=int, default=1_000_000)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the in-process engines (default cuda; cpu runs "
        "on the host)",
    )
    args = ap.parse_args(argv)
    from trino_tpu_torch import resolve_device

    device = resolve_device(args.device)  # raises without a GPU for cuda
    with open(args.queries) as f:
        queries = [q for q in f.read().split(";") if q.strip()]
    failures = verify(args.control, args.test, queries, args.max_rows, device)
    print(f"{len(queries)} queries, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
