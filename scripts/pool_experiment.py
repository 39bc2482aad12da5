"""Graph pool rules on TPC-DS Q64 and Q95 at SF10, on one CUDA card.

Runs Q64 three times, Q95 twice, then Q64 again through
``LocalQueryRunner(device="cuda")`` in distributed mode with
``join_strategy=auto``, once a pool rule, with the engine's programs
evicted between rules. One JSON line a run: time, rows against the
committed answers, the pool's captures, eager hits, recaptures and
dropped graphs in that run, and each generation's segment and live
bytes after it. The rules:

- ``live``: the port's rule (``ProgramPool.make_room``): every capture
  on the pool's one stream, a generation closed once its graphs' live
  blocks pass half the budget;
- ``segments``: one stream, a generation closed once its segments pass
  half the budget;
- ``noclose``: one stream, a generation closed only past the budget;
- ``newstream``: a new stream a capture (the allocator then hands a
  capture none of the blocks an earlier capture freed), closed as in
  ``segments``.

Usage: ``python3 scripts/pool_experiment.py live,segments,noclose,newstream``
(the first Q64 run generates the SF10 tables it reads, ~90 s).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from trino_tpu_torch.benchmarks import tpcds as DS  # noqa: E402
from trino_tpu_torch.benchmarks import tpch as B  # noqa: E402
from trino_tpu_torch.exec import programs as PR  # noqa: E402
from trino_tpu_torch.testing import LocalQueryRunner  # noqa: E402


def log(**kv) -> None:
    print(json.dumps(kv, default=str), flush=True)


def generations(pool) -> dict:
    """Segment and live bytes of each generation, oldest first."""
    return {i: pool._segments_by_generation()[id(g)] for i, g in enumerate(pool._gens)}


def close_at(limit):
    """A ``make_room`` that closes the newest generation once its
    segments pass ``limit(budget)``."""
    def make_room(self):
        by_gen = self._reserved_by_generation()
        if by_gen is None:
            return
        if self._gens and by_gen.get(id(self._gens[-1]), 0) > limit(self.budget_bytes):
            self._gens[-1]["open"] = False
        self._fit_budget(by_gen)
    return make_room


RULES = {
    "live": (PR.ProgramPool.make_room, False),
    "segments": (close_at(lambda b: b // 2), False),
    "noclose": (close_at(lambda b: b), False),
    "newstream": (close_at(lambda b: b // 2), True),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_experiment: needs a CUDA card", file=sys.stderr)
        return 2
    answers = B.load_answers(DS.ANSWERS_SF10)
    texts = DS.queries(answers["schema"])
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    runner.session.set("join_strategy", "auto")
    pool = runner.engine.program_pool
    log(budget_bytes=pool.budget_bytes)
    one_stream = PR.ProgramPool.stream
    for rule in sys.argv[1].split(","):
        make_room, new_stream = RULES[rule]
        pool.evict_lru()
        torch.cuda.empty_cache()
        PR.ProgramPool.make_room = make_room
        PR.ProgramPool.stream = ((lambda self: torch.cuda.Stream(self.device))
                                 if new_stream else one_stream)
        for q in (64, 64, 64, 95, 95, 64):
            before = (pool.captures, pool.eager_hits, pool.recaptures, pool.dropped)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.engine.execute_statement(texts[q], runner.session)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want = answers["queries"][str(q)]
            bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
            after = (pool.captures, pool.eager_hits, pool.recaptures, pool.dropped)
            log(rule=rule, query=f"Q{q}", ms=ms, matches_reference=bad is None,
                captures_eager_hits_recaptures_dropped=[a - b for a, b in zip(after, before)],
                pool_reserved_bytes=pool.reserved_bytes(),
                generations_segment_and_live_bytes=generations(pool),
                trace_count=res.trace_count)
    PR.ProgramPool.make_room = RULES["live"][0]
    PR.ProgramPool.stream = one_stream
    return 0


if __name__ == "__main__":
    sys.exit(main())
