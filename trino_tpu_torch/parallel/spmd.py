"""SPMD query execution across server processes: one mesh over all of them.

Counterpart of ``trino_tpu/parallel/spmd.py``. Trino runs a fragment as
tasks on many workers with HTTP shuffle between them
(``SqlQueryScheduler.java:538``); the reference runs each fragment as one
multi-host pjit program over a ``jax.distributed`` mesh. Here every
server process joins one ``torch.distributed`` group
(:func:`initialize_spmd`), all of them build one mesh that spans the
processes, one shard a process (``parallel/mesh.py``), and the
collectives of the fragment programs cross processes through the group's
transport (``parallel/transport.py``: gloo on the CPU, peer copies
through CUDA IPC between processes that share one card). The control
plane ships only the plan: every process runs the same fragment programs
in the same order, so the collectives pair up without any other message.

Protocol (two-phase, as the reference's):

- all server processes boot inside the group (rank 0 the coordinator)
  and build the same mesh;
- a query arrives at the coordinator. If the plan is fusable it takes a
  sequence number and **prepares** it on every worker (``POST /v1/spmd``
  with ``phase=prepare``: plan and session are staged, nothing runs). If
  any peer is unreachable the coordinator aborts the slot
  (``phase=commit, go=false``) and the query falls back to per-task
  cluster scheduling: a lost peer costs one round trip, not an error;
- on all-ready the coordinator **commits** (``phase=commit, go=true``);
  every process (the coordinator too) runs committed slots strictly in
  sequence order, so the collectives of one query meet those of the same
  query on every process. An aborted slot advances the sequence without
  running anything;
- several queries may be in flight: sequence allocation and the prepare
  round trips overlap; only the run order is serialized;
- every host read of the fragment path (flags, match counts, counters,
  first capacities, dynamic-filter domains) is reduced over the group
  before a decision is made from it, so capacity retries run alike on
  every process;
- the root result is gathered to every process, and the coordinator
  answers the client.

A worker's commit reply carries its own run's exchange counters, kernel
launches and transport figures; the coordinator's result holds them
under ``spmd``.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Optional

from trino_tpu_torch.config import Session
from trino_tpu_torch.exec.local import ExecutionError
from trino_tpu_torch.planner import plan as P

# the group's deadline of one collective or barrier: the longest gap
# between two collectives of a query is one process's cold generation of
# an SF1 table's splits (seconds on the card), so a group that diverged
# fails within it
TIMEOUT_S = 120.0


class SpmdUnsupported(Exception):
    """Plan not executable as one fused program over the processes."""


def session_to_json(session: Session) -> dict:
    return {
        "user": session.user,
        "catalog": session.catalog,
        "schema": session.schema,
        "properties": {
            k: v
            for k, v in session.properties.items()
            if isinstance(v, (str, int, float, bool))
        },
    }


def session_from_json(d: dict) -> Session:
    s = Session(
        user=d.get("user", "spmd"),
        catalog=d.get("catalog", "tpch"),
        schema=d.get("schema", "tiny"),
    )
    for k, v in d.get("properties", {}).items():
        s.properties[k] = v
    return s


class SpmdRunner:
    """Per-process SPMD execution endpoint (coordinator and workers)."""

    def __init__(self, engine):
        from trino_tpu_torch.parallel.mesh import make_mesh

        self.engine = engine
        # the mesh over every process of the group (one shard a process)
        self.mesh = make_mesh(device=engine.device)
        self.process_count = self.mesh.world
        self._seq_lock = threading.Lock()  # sequence allocation only
        self._seq = 0
        self._done_seq = -1
        self._cond = threading.Condition()
        self._pending: dict[int, dict] = {}  # staged prepares (worker side)

    # --- launch-order gate ------------------------------------------------

    def _await_turn(self, seq: int, timeout: float = 600.0) -> bool:
        """Block until every earlier slot completed or was aborted."""
        with self._cond:
            while self._done_seq < seq - 1:
                if not self._cond.wait(timeout=timeout):
                    return False
        return True

    def _finish(self, seq: int) -> None:
        with self._cond:
            self._done_seq = max(self._done_seq, seq)
            self._cond.notify_all()

    # --- shared execution body -------------------------------------------

    def _execute(self, plan: P.PlanNode, session: Session, stats: Optional[dict] = None):
        """The query's fragments over the mesh that spans the processes;
        ``stats`` (when given) receives this process's exchange counters,
        kernel launches and transport figures of the run."""
        import time

        from trino_tpu_torch import _kernels
        from trino_tpu_torch.exec.fragments import FragmentedExecutor, query_fusable
        from trino_tpu_torch.planner.fragmenter import fragment_plan

        if not query_fusable(fragment_plan(plan)):
            raise SpmdUnsupported("plan contains non-fusable nodes")
        local = Session(
            user=session.user, catalog=session.catalog, schema=session.schema
        )
        for k, v in session.properties.items():
            if k not in ("execution_mode",):
                local.properties[k] = v
        # spill deferral would diverge program streams across processes
        local.properties["spill_enabled"] = False
        transport = self.mesh.transport
        launches0 = dict(_kernels.LAUNCHES)
        moved0 = dict(transport.stats) if transport is not None else {}
        t0 = time.perf_counter()
        # no program pool: a capture cannot hold the collectives' host
        # barriers, so every program runs as its function
        executor = FragmentedExecutor(self.engine.catalogs, local, self.engine.device, self.mesh)
        out = executor.execute(plan)
        if stats is not None:
            stats["rank"] = self.mesh.rank
            stats["ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            stats["exchange"] = executor.exchange_stats_snapshot()
            stats["launches"] = {k: v - launches0.get(k, 0) for k, v in _kernels.LAUNCHES.items()}
            if transport is not None:
                stats["transport"] = {
                    **transport.describe(),
                    **{k: round(v - moved0.get(k, 0), 3) for k, v in transport.stats.items()},
                }
        return out

    # --- coordinator side -------------------------------------------------

    def execute(self, plan: P.PlanNode, session: Session, peers: list[str],
                stats: Optional[dict] = None):
        """Run one query SPMD across all processes; returns (batch, names).

        ``peers`` are the worker base URIs (everyone but this process).
        ``stats`` (when given) receives ``seq``, this process's run and
        each worker's commit reply."""
        from trino_tpu_torch.exec.fragments import query_fusable
        from trino_tpu_torch.planner.fragmenter import fragment_plan
        from trino_tpu_torch.planner.serde import node_to_json

        # decide fusability BEFORE broadcasting: non-fusable plans fall
        # back to per-task cluster scheduling without touching workers
        if not query_fusable(fragment_plan(plan)):
            raise SpmdUnsupported("plan contains non-fusable nodes")
        if len(peers) != self.process_count - 1:
            # the programs need EVERY rank of the fixed group; an
            # un-announced (or lapsed) rank would never run them and the
            # collectives would wait out their deadline: task scheduling
            raise SpmdUnsupported(
                f"{len(peers)} peers announced, need {self.process_count - 1}"
            )
        with self._seq_lock:
            seq = self._seq
            self._seq += 1

        def post(uri: str, body: dict, timeout: float) -> dict:
            from trino_tpu_torch.server import auth

            req = urllib.request.Request(
                f"{uri}/v1/spmd",
                data=json.dumps(body).encode(),
                method="POST",
                headers=auth.headers(),
            )
            req.add_header("Content-Type", "application/json")
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read().decode())

        def broadcast(body: dict, timeout: float) -> list:
            """POST to all peers concurrently -> list of (uri, reply|exc)."""
            results: list = [None] * len(peers)

            def one(i: int, uri: str):
                try:
                    results[i] = (uri, post(uri, body, timeout))
                except Exception as e:  # noqa: BLE001
                    results[i] = (uri, e)

            ts = [
                threading.Thread(target=one, args=(i, u), daemon=True)
                for i, u in enumerate(peers)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=timeout + 30)
            return [r if r is not None else (peers[i], TimeoutError("no reply"))
                    for i, r in enumerate(results)]

        # phase 1 — prepare: stage the plan everywhere; nothing runs, so
        # a dead peer here is recoverable (fall back to task scheduling)
        prepare = {
            "phase": "prepare",
            "seq": seq,
            "plan": node_to_json(plan),
            "session": session_to_json(session),
        }
        failed = [
            (uri, r)
            for uri, r in broadcast(prepare, timeout=30)
            if isinstance(r, Exception) or r.get("error")
        ]
        if failed:
            # abort the slot everywhere so sequence numbers stay aligned
            broadcast({"phase": "commit", "seq": seq, "go": False}, timeout=30)
            self._await_turn(seq)
            self._finish(seq)
            raise SpmdUnsupported(
                f"peer unavailable at prepare ({failed[0][0]}): {failed[0][1]}"
            )

        # phase 2 — commit: everyone (us included) runs in seq order
        errors: list[str] = []
        replies: list[dict] = []
        commit_threads = []

        def commit(uri: str):
            try:
                body = post(
                    uri, {"phase": "commit", "seq": seq, "go": True}, 600
                )
                if body.get("error"):
                    errors.append(body["error"])
                replies.append(body)
            except Exception as e:  # noqa: BLE001
                errors.append(f"{uri}: {e}")

        for uri in peers:
            t = threading.Thread(target=commit, args=(uri,), daemon=True)
            t.start()
            commit_threads.append(t)
        if not self._await_turn(seq):
            # predecessors abandoned: advance past them and run this slot
            with self._cond:
                self._done_seq = max(self._done_seq, seq - 1)
                self._cond.notify_all()
        own: dict = {}
        try:
            result = self._execute(plan, session, own)
        finally:
            self._finish(seq)
            for t in commit_threads:
                t.join(timeout=600)
        if errors:
            raise ExecutionError(f"spmd worker failed: {errors[0]}")
        if stats is not None:
            stats.update({
                "seq": seq, "processes": self.process_count, "coordinator": own,
                "workers": sorted((r.get("stats") or {} for r in replies),
                                  key=lambda s: s.get("rank", 0)),
            })
        return result

    # --- worker side ------------------------------------------------------

    def execute_remote(self, payload: dict) -> dict:
        """Handle POST /v1/spmd on a worker (two-phase)."""
        from trino_tpu_torch.planner.serde import node_from_json

        seq = int(payload["seq"])
        phase = payload.get("phase", "prepare")
        if phase == "prepare":
            with self._cond:
                if self._done_seq >= seq:
                    return {"error": f"seq {seq} slot already passed"}
            self._pending[seq] = payload
            return {"ready": True, "seq": seq}

        go = bool(payload.get("go", True))
        pend = self._pending.pop(seq, None)
        with self._cond:
            if self._done_seq >= seq:
                # this slot was declared abandoned while its commit was in
                # flight; running now would be out of launch order
                return {"error": f"seq {seq} slot already passed"}
        if not self._await_turn(seq):
            # predecessors abandoned (commit or abort never arrived, e.g.
            # a missed go=False broadcast): advance past THEM and serve
            # this slot; the abandoned slots' late commits are rejected
            # by the guard above, so the healthy query is not the victim
            with self._cond:
                self._done_seq = max(self._done_seq, seq - 1)
                self._cond.notify_all()
        # TOCTOU re-check: while this commit was blocked in _await_turn a
        # SUCCESSOR's timeout may have advanced done_seq past this slot
        # (declared it abandoned). Running now would start its programs
        # out of launch order across processes, and their collectives
        # would meet another query's.
        with self._cond:
            if self._done_seq >= seq:
                return {"error": f"seq {seq} slot already passed"}
        try:
            if not go:
                return {"skipped": True, "seq": seq}
            if pend is None:
                return {"error": f"seq {seq} committed without prepare"}
            plan = node_from_json(pend["plan"])
            session = session_from_json(pend.get("session", {}))
            stats: dict = {}
            self._execute(plan, session, stats)
            return {"ok": True, "seq": seq, "stats": stats}
        except Exception as e:  # noqa: BLE001
            return {"error": f"{type(e).__name__}: {e}", "seq": seq}
        finally:
            self._finish(seq)


def initialize_spmd(coordinator: str, num_processes: int, process_id: int,
                    device=None) -> None:
    """Join the group (call before the engine touches its device, as the
    reference's must be called before any jax computation): a gloo
    ``torch.distributed`` process group over ``tcp://<coordinator>``,
    ``num_processes`` ranks, this one ``process_id``, every collective
    and barrier under :data:`TIMEOUT_S`; then the group's data plane on
    ``device`` (``parallel/transport.py``: gloo on the CPU, an exchange
    arena shared over CUDA IPC on a card)."""
    import datetime

    import torch.distributed as dist

    from trino_tpu_torch import resolve_device
    from trino_tpu_torch.parallel import transport as TR

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    TR.install(TR.open_transport(resolve_device(device)))
