"""Test harness: the LocalQueryRunner and DistributedQueryRunner analogs.

Reference: ``core/trino-main/src/main/java/io/trino/testing/LocalQueryRunner.java:221,631``
(single-process full stack) and ``DistributedQueryRunner.java:72`` (here N
mesh shards on one device, with the exchanges between them). Both
delegate to :class:`trino_tpu_torch.engine.Engine`.
:class:`MultiProcessQueryRunner` boots a coordinator and worker processes
(``execution_mode=cluster``).
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


class MultiProcessQueryRunner:
    """N separate server *processes* — a coordinator and N workers — with
    queries flowing through real HTTP task dispatch and page exchange.

    Reference: ``testing/trino-testing/.../DistributedQueryRunner.java:72``
    (N real TestingTrinoServer instances; here real OS processes, which is
    stricter: nothing can leak through shared memory); a port of
    ``trino_tpu/testing.py:71-339``. With ``spmd=True`` the processes form
    one SPMD group (``parallel/spmd.py``): a free rendezvous port, the
    coordinator rank 0, every process spawned before any ``LISTENING``
    line is read (each waits in the group's rendezvous until all have
    joined), every collective under ``parallel/spmd.py::TIMEOUT_S``.

    Every process runs ``python -m trino_tpu_torch.server.main`` on
    ``device`` (``cuda`` unless the caller asks for the CPU). On a card the
    processes share it: each holds ``card_share`` of it (1/(N+1) by
    default; ``memory.set_card_share``), which the reference does not
    need, a TPU chip being never shared by processes. ``command`` replaces
    ``[python, -m, trino_tpu_torch.server.main]`` for every process (a
    launcher that instruments a process before the server starts). On the
    CPU each process runs :data:`CPU_THREADS` intra-op threads unless the
    environment sets ``OMP_NUM_THREADS``. Every wait has a deadline.
    """

    BOOT_TIMEOUT_S = 180.0
    ANNOUNCE_TIMEOUT_S = 60.0
    # intra-op threads of a CPU cluster's process
    CPU_THREADS = 2

    def __init__(
        self,
        n_workers: int = 2,
        device=None,
        cluster_memory_limit_bytes: Optional[int] = None,
        catalogs: Optional[list] = None,
        card_share: Optional[float] = None,
        command: Optional[list] = None,
        extra_env: Optional[dict] = None,
        spmd: bool = False,
    ):
        import json as _json
        import os
        import secrets as _secrets
        import sys
        import time
        import urllib.request

        from trino_tpu_torch import resolve_device
        from trino_tpu_torch.server.auth import ENV_VAR as _AUTH_ENV

        self.device = resolve_device(device)
        self._procs: list = []
        self._logs: list[list[str]] = []
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        # one internal credential per PROCESS (not per cluster): rotating
        # it would 401 the parent's calls to an older still-live cluster
        if not os.environ.get(_AUTH_ENV):
            os.environ[_AUTH_ENV] = _secrets.token_hex(16)
        env[_AUTH_ENV] = os.environ[_AUTH_ENV]
        # the children find the package however the parent was launched
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH")) if p
        )
        if self.device.type == "cpu":
            # a CPU cluster's processes share the host's cores with each
            # other (and with a test run's other processes)
            env.setdefault("OMP_NUM_THREADS", str(self.CPU_THREADS))
        env.update(extra_env or {})
        self._env = env
        self._cwd = repo
        self._command = list(command or [sys.executable, "-m", "trino_tpu_torch.server.main"])
        if card_share is None:
            card_share = 1.0 / (n_workers + 1) if self.device.type == "cuda" else 1.0
        self.card_share = float(card_share)
        self.spmd = spmd
        # one group: the coordinator rank 0, worker i rank i + 1
        self._spmd_args: list[list[str]] = []
        if spmd:
            rendezvous = f"127.0.0.1:{_free_port()}"
            self._spmd_args = [
                ["--spmd-coordinator", rendezvous, "--spmd-procs", str(n_workers + 1),
                 "--spmd-rank", str(rank)]
                for rank in range(n_workers + 1)
            ]
        catalog_args: list[str] = []
        for spec in catalogs or []:
            catalog_args += ["--catalog", spec]
        self._catalog_args = catalog_args
        # the coordinator's port is chosen here, so that every process
        # boots at once (a worker announces with backoff until the
        # coordinator listens)
        port = _free_port()
        self.coordinator_uri = f"http://127.0.0.1:{port}"
        coord_args = (["--role", "coordinator", "--port", str(port)]
                      + self._device_args() + catalog_args)
        if cluster_memory_limit_bytes is not None:
            coord_args += ["--cluster-memory-limit-bytes", str(cluster_memory_limit_bytes)]
        try:
            coord_proc = self._popen(coord_args + (self._spmd_args[0] if spmd else []))
            # every process before any LISTENING line: an SPMD rank waits
            # in the group's rendezvous until all have joined
            self._worker_procs = [
                self._popen(self._worker_args(i) + (self._spmd_args[i + 1] if spmd else []))
                for i in range(n_workers)
            ]
            self.coordinator_uri = self._await_listening(coord_proc)
            self.worker_uris = [self._await_listening(p) for p in self._worker_procs]
            # wait for every worker to be announced and healthy
            deadline = time.time() + self.ANNOUNCE_TIMEOUT_S
            while time.time() < deadline:
                with urllib.request.urlopen(f"{self.coordinator_uri}/v1/node", timeout=10) as r:
                    info = _json.loads(r.read().decode())
                if len(info.get("nodes", [])) >= n_workers:
                    break
                time.sleep(0.2)
            else:
                raise TimeoutError("workers did not announce in time")
        except BaseException:
            self.close()
            raise

    def _device_args(self) -> list[str]:
        return ["--device", str(self.device.type), "--card-share", repr(self.card_share)]

    def _popen(self, args):
        import subprocess

        proc = subprocess.Popen(
            [*self._command, *args],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=self._env,
            cwd=self._cwd,
        )
        self._procs.append(proc)
        return proc

    def _await_listening(self, proc) -> str:
        """The ``LISTENING <uri>`` line of a booting server, within
        ``BOOT_TIMEOUT_S`` (a reader thread: ``readline`` alone could block
        past any deadline)."""
        import queue
        import threading

        lines: "queue.Queue" = queue.Queue()
        log: list[str] = []
        self._logs.append(log)

        def drain(stream=proc.stdout):
            # keep draining the pipe: an undrained 64KB pipe buffer
            # blocks the child on its next write and freezes it
            for ln in stream:
                log.append(ln)
                lines.put(ln)
            lines.put(None)

        threading.Thread(target=drain, daemon=True).start()
        try:
            while True:
                ln = lines.get(timeout=self.BOOT_TIMEOUT_S)
                if ln is None:
                    proc.wait(timeout=10)
                    raise RuntimeError(f"server process exited: {''.join(log)}")
                if ln.startswith("LISTENING "):
                    return ln.split()[1].strip()
        except queue.Empty:
            raise TimeoutError(f"server did not start in time: {''.join(log)}") from None

    def _worker_args(self, i: int) -> list[str]:
        return [
            "--role", "worker",
            "--node-id", f"worker-{i}",
            "--discovery", self.coordinator_uri,
        ] + self._device_args() + self._catalog_args

    def logs(self) -> list[str]:
        """Every process's output so far, one string a process."""
        return ["".join(log) for log in self._logs]

    def execute(self, sql: str, session_properties: Optional[dict] = None):
        from trino_tpu_torch.client import ClientSession, StatementClient

        cs = ClientSession(
            properties={"execution_mode": "cluster", **(session_properties or {})}
        )
        client = StatementClient(self.coordinator_uri, sql, cs)
        rows = list(client.rows())
        names = [c.name for c in client.columns] if client.columns else []
        return rows, names

    # --- chaos / lifecycle hooks -----------------------------------------

    def kill_worker(self, i: int, timeout: float = 10.0) -> None:
        """SIGKILL worker ``i`` — no drain, no goodbye; simulates node
        death for spool/lineage recovery tests."""
        p = self._worker_procs[i]
        p.kill()
        p.wait(timeout=timeout)

    def drain_worker(self, i: int, timeout: float = 120.0) -> None:
        """Graceful decommission: ``PUT /v1/info/state SHUTTING_DOWN``
        stops admission, finishes running tasks, force-spools retained
        buffers, deregisters, and exits the process."""
        import urllib.request

        from trino_tpu_torch.server import auth as _auth

        req = urllib.request.Request(
            f"{self.worker_uris[i]}/v1/info/state",
            data=b'"SHUTTING_DOWN"',
            method="PUT",
            headers=_auth.headers(),
        )
        urllib.request.urlopen(req, timeout=10)
        self._worker_procs[i].wait(timeout=timeout)

    def restart_worker(self, i: int, timeout: float = 60.0) -> str:
        """Respawn worker ``i`` (same node id, fresh port) and wait until
        the coordinator has re-registered its announce."""
        import json as _json
        import time
        import urllib.request

        proc = self._popen(self._worker_args(i))
        uri = self._await_listening(proc)
        self._worker_procs[i] = proc
        self.worker_uris[i] = uri
        deadline = time.time() + timeout
        while time.time() < deadline:
            with urllib.request.urlopen(f"{self.coordinator_uri}/v1/node", timeout=10) as r:
                info = _json.loads(r.read().decode())
            for n in info.get("nodes", []):
                if n.get("nodeId") == f"worker-{i}" and n.get("uri") == uri:
                    return uri
            time.sleep(0.2)
        raise TimeoutError(f"worker-{i} did not re-announce in time")

    def close(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001
                p.kill()
                p.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]
