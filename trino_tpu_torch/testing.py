"""Test harness: the LocalQueryRunner and DistributedQueryRunner analogs.

Reference: ``core/trino-main/src/main/java/io/trino/testing/LocalQueryRunner.java:221,631``
(single-process full stack) and ``DistributedQueryRunner.java:72`` (here N
mesh shards on one device, with the exchanges between them). Both
delegate to :class:`trino_tpu_torch.engine.Engine`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from trino_tpu_torch.config import Session
from trino_tpu_torch.engine import Engine
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.sql import parse_statement


class LocalQueryRunner:
    """Parse -> analyze/plan -> execute, one process, no RPC.

    The runner's one session carries what outlives a statement: SET
    SESSION properties, prepared statements and the id of an open
    transaction. ``device`` defaults to ``cuda`` and raises without a GPU
    unless the caller passes ``device="cpu"``."""

    def __init__(
        self,
        session: Optional[Session] = None,
        engine: Optional[Engine] = None,
        device=None,
    ):
        self.session = session or Session()
        # sharing an engine across runners shares connector state
        self.engine = engine or Engine(device=device)

    @property
    def catalogs(self):
        return self.engine.catalogs

    def plan(self, sql: str) -> P.PlanNode:
        return self.engine.plan(parse_statement(sql), self.session)

    def execute(self, sql: str) -> tuple[list[tuple], list[str]]:
        res = self.engine.execute_statement(sql, self.session)
        return res.rows, res.column_names

    def explain(self, sql: str) -> str:
        return P.plan_text(self.plan(sql))

    def assert_query(self, sql: str, expected: Sequence[tuple], ordered: bool = False):
        rows, _ = self.execute(sql)
        got = rows if ordered else sorted(map(tuple, rows))
        want = list(expected) if ordered else sorted(map(tuple, expected))
        assert got == want, f"query mismatch:\n got: {got[:20]}\nwant: {want[:20]}"


class DistributedQueryRunner(LocalQueryRunner):
    """A runner over a mesh of ``n_devices`` shards (one by default) on
    ``device``: every query runs in ``execution_mode=distributed`` with
    the exchanges between shards (reference ``testing.py:58-68``; all
    shards share the one device, ``parallel/mesh.py``)."""

    def __init__(self, session: Optional[Session] = None, n_devices: Optional[int] = None,
                 device=None, engine: Optional[Engine] = None):
        super().__init__(session, engine=engine, device=device)
        from trino_tpu_torch.parallel.mesh import make_mesh

        self.mesh = make_mesh(n_devices, self.engine.device)
        self.engine.mesh = self.mesh
        self.session.set("execution_mode", "distributed")
