"""Compute the reference answers of the 22 TPC-H queries at ``tpch.sf1``.

Runs every spec query through the JAX package's ``LocalQueryRunner`` on
the CPU and writes its rows and column types, in canonical text (DECIMALs
and DATEs as strings), with the output positions of each query's ORDER BY
keys, to ``trino_tpu_torch/benchmarks/tpch_sf1_answers.json``. The
port's ``chip_smoke.py`` holds its SF1 rows against that file. Takes
about 15 minutes on 8 CPU cores:

    JAX_PLATFORMS=cpu python scripts/tpch_sf1_answers.py [--schema tpch.sf1] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compute(schema: str = "tpch.sf1", log=None) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from trino_tpu.benchmarks.tpch import queries as ref_queries
    from trino_tpu.testing import LocalQueryRunner as RefRunner
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.testing import LocalQueryRunner

    ref = RefRunner()
    planner = LocalQueryRunner(device="cpu")
    out = {"schema": schema, "queries": {}}
    for q, sql in ref_queries(schema).items():
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
    from trino_tpu_torch.benchmarks.tpch import ANSWERS_SF1

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schema", default="tpch.sf1")
    ap.add_argument("--out", default=ANSWERS_SF1)
    args = ap.parse_args()
    data = compute(args.schema, log=lambda m: print(m, flush=True))
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, args.out)


if __name__ == "__main__":
    main()
