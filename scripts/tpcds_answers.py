"""Compute the reference answers of the 64 TPC-DS queries.

Runs every query of the port's TPC-DS corpus (``trino_tpu_torch/
benchmarks/tpcds.py``, the same text as the reference's test corpus)
through the JAX package's ``LocalQueryRunner`` on the CPU, with
``execution_mode=local`` (the interpreter: the reference's fused run of
Q99 is unreliable), and writes its rows and column types, in canonical
text (DECIMALs and DATEs as strings), with the output positions of each
query's ORDER BY keys, to
``trino_tpu_torch/benchmarks/tpcds_<scale>_answers.json``. The port's
tests hold its ``tpcds.tiny`` rows against the tiny file, and
``chip_smoke.py`` its ``tpcds.sf1`` rows against the SF1 file:

    JAX_PLATFORMS=cpu python scripts/tpcds_answers.py --scale tiny
    JAX_PLATFORMS=cpu python scripts/tpcds_answers.py --scale sf1
    JAX_PLATFORMS=cpu python scripts/tpcds_answers.py --scale sf10 --queries 64,95
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def answers_path(scale: str) -> str:
    from trino_tpu_torch.benchmarks import tpcds

    return os.path.join(
        os.path.dirname(tpcds.__file__), f"tpcds_{scale}_answers.json"
    )


def compute(scale: str = "tiny", qids=None, log=None) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from trino_tpu.testing import LocalQueryRunner as RefRunner
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.benchmarks.tpcds import queries
    from trino_tpu_torch.testing import LocalQueryRunner

    schema = f"tpcds.{scale}"
    ref = RefRunner()
    ref.session.set("execution_mode", "local")
    planner = LocalQueryRunner(device="cpu")
    out = {"schema": schema, "queries": {}}
    for q, sql in queries(schema).items():
        if qids is not None and q not in qids:
            continue
        t0 = time.perf_counter()
        res = ref.engine.execute_statement(sql, ref.session)
        out["queries"][str(q)] = {
            "types": [t.name for t in res.column_types],
            "order_by": B.order_positions(planner.plan(sql)),
            "rows": B.canonical_rows(res.rows),
        }
        if log:
            log(f"Q{q}: {len(res.rows)} rows, {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="tiny", help="tiny, sf1, sf10, ...")
    ap.add_argument("--queries", default=None,
                    help="comma-separated query numbers (default: all 64)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    qids = None if args.queries is None else {int(q) for q in args.queries.split(",")}
    out = args.out or answers_path(args.scale)
    t0 = time.perf_counter()
    data = compute(args.scale, qids, log=lambda m: print(m, flush=True))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, out)


if __name__ == "__main__":
    main()
