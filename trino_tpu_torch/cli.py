"""Interactive SQL CLI.

Reference: ``client/trino-cli`` (``Console.java``, ``Query.java``,
``StatusPrinter.java``) — REPL, aligned/CSV/JSON output formats, \\commands.
Stdlib-only (the reference uses JLine).

Usage:
    python -m trino_tpu_torch.cli --server http://127.0.0.1:8080 [--execute SQL]
                            [--output-format ALIGNED|CSV|JSON]

A copy of ``trino_tpu/cli.py``: ``python -m trino_tpu_torch.cli --server
URI -e SQL``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from trino_tpu_torch.client import ClientSession, QueryFailure, StatementClient


def format_aligned(names: list[str], rows: list[tuple]) -> str:
    cols = [names] + [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    widths = [max(len(row[i]) for row in cols) for i in range(len(names))]
    def line(row):
        return " | ".join(s.ljust(w) for s, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    out = [line(names), sep]
    out += [line(r) for r in cols[1:]]
    return "\n".join(out)


def format_csv(names: list[str], rows: list[tuple]) -> str:
    import csv
    import io

    buf = io.StringIO()
    w = csv.writer(buf)
    for r in rows:
        w.writerow(["" if v is None else v for v in r])
    return buf.getvalue().rstrip("\n")


def format_json(names: list[str], rows: list[tuple]) -> str:
    return "\n".join(
        json.dumps({n: (str(v) if v is not None and not isinstance(v, (int, float, bool, str)) else v)
                    for n, v in zip(names, r)})
        for r in rows
    )


FORMATS = {"ALIGNED": format_aligned, "CSV": format_csv, "JSON": format_json}


def run_statement(server: str, session: ClientSession, sql: str, fmt: str) -> int:
    t0 = time.time()
    client = StatementClient(server, sql, session)
    try:
        rows = list(client.rows())
    except QueryFailure as f:
        print(f"Query failed: {f}", file=sys.stderr)
        return 1
    names = [c.name for c in client.columns] if client.columns else []
    if client.update_type:
        n = f" {client.update_count} rows" if client.update_count is not None else ""
        print(f"{client.update_type}{n}")
    if rows or not client.update_type:
        formatter = FORMATS[fmt]
        if fmt == "ALIGNED":
            print(formatter(names, rows))
            dt = time.time() - t0
            print(f"({len(rows)} row{'s' if len(rows) != 1 else ''} in {dt:.2f}s)")
        else:
            print(formatter(names, rows))
    return 0


def repl(server: str, session: ClientSession, fmt: str) -> int:
    print(f"trino-tpu CLI — connected to {server}")
    print('Type a SQL statement ending with ";", or "quit".')
    buf: list[str] = []
    while True:
        try:
            prompt = "trino> " if not buf else "    -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        stripped = line.strip()
        if not buf and stripped.lower() in ("quit", "exit", "quit;", "exit;"):
            return 0
        if not buf and not stripped:
            continue
        buf.append(line)
        if stripped.endswith(";"):
            sql = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            run_statement(server, session, sql, fmt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu")
    ap.add_argument("--server", default="http://127.0.0.1:8080")
    ap.add_argument("--user", default="user")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    ap.add_argument(
        "--output-format", default="ALIGNED", choices=sorted(FORMATS)
    )
    args = ap.parse_args(argv)
    session = ClientSession(args.user, args.catalog, args.schema)
    if args.execute:
        return run_statement(args.server, session, args.execute, args.output_format)
    return repl(args.server, session, args.output_format)


if __name__ == "__main__":
    sys.exit(main())
