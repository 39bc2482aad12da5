"""Speculative (hedged) task execution.

Reference tier: Trino's speculative-execution / adaptive-scheduling
territory (``FaultTolerantExecution*`` + straggler mitigation in the
MPP literature). Coverage:

- detector math (``SpeculationConfig``: quorum, floor/multiplier, budget)
- deterministic slow-worker delay faults (``FaultInjector``)
- loser cancellation on the worker (``CANCELED_SPECULATIVE``, aborted
  output buffer → no double-delivered pages)
- first-finisher-wins dispatch in ``ClusterScheduler._await_fragment``
  (fake remote tasks: hedge wins, primary wins, budget cap)
- ``ManagedQuery._fire_completed`` single-fire under a thread race
- chaos: a real 2-worker cluster with one 10× slow worker stays
  bit-identical with speculation on, and records a hedge win

The reference's ``tests/test_speculation.py`` run against
trino_tpu_torch, with the port's own case at the end: the detector's
thresholds, budgets and slow-worker targets equal the reference's. Its
chaos on a cluster (``TestSlowWorkerChaos``) runs on the cluster of
``test_torch_fault_tolerance.py``; there the slow worker also stalls
before executing, the port's CPU tasks being too quick for ten times
their time to pass the 100 ms floor.
"""

import threading
import time
from types import SimpleNamespace

import pytest

from trino_tpu_torch.config import Session
from trino_tpu_torch.ft.injection import FaultInjector
from trino_tpu_torch.ft.retry import SpeculationConfig
from trino_tpu_torch.server.statemachine import TERMINAL_TASK_STATES, TaskState


# === unit: detector math =================================================


class TestSpeculationConfig:
    def test_disabled_by_default(self):
        cfg = SpeculationConfig()
        assert not cfg.enabled
        assert cfg.budget(100) == 0
        assert cfg.threshold_ms([1.0] * 50) is None

    def test_from_session_reads_props(self):
        s = Session(properties={
            "speculation": True,
            "speculation_floor_ms": 250,
            "speculation_multiplier": 3.0,
            "speculation_max_fraction": 0.5,
        })
        cfg = SpeculationConfig.from_session(s)
        assert cfg.enabled
        assert cfg.floor_ms == 250.0
        assert cfg.multiplier == 3.0
        assert cfg.max_fraction == 0.5

    def test_from_session_defaults_off(self):
        cfg = SpeculationConfig.from_session(Session())
        assert not cfg.enabled

    def test_quorum_blocks_threshold(self):
        cfg = SpeculationConfig(enabled=True, min_completed=3)
        assert cfg.threshold_ms([]) is None
        assert cfg.threshold_ms([100.0, 100.0]) is None
        assert cfg.threshold_ms([100.0, 100.0, 100.0]) is not None

    def test_threshold_multiplier_of_p99(self):
        cfg = SpeculationConfig(
            enabled=True, floor_ms=0.0, multiplier=2.0
        )
        t = cfg.threshold_ms([100.0] * 10)
        assert t == pytest.approx(200.0, rel=0.05)

    def test_floor_dominates_fast_siblings(self):
        # sub-ms siblings must not brand everything a straggler
        cfg = SpeculationConfig(
            enabled=True, floor_ms=500.0, multiplier=2.0
        )
        assert cfg.threshold_ms([1.0, 2.0, 1.5]) == 500.0

    def test_budget_fraction_and_minimum(self):
        cfg = SpeculationConfig(enabled=True, max_fraction=0.25)
        assert cfg.budget(8) == 2
        assert cfg.budget(2) == 1  # at least one hedge when enabled
        assert cfg.budget(0) == 1

    def test_clamps(self):
        cfg = SpeculationConfig(
            enabled=True, floor_ms=-5, multiplier=0.1, max_fraction=-1
        )
        assert cfg.floor_ms == 0.0
        assert cfg.multiplier == 1.0
        assert cfg.max_fraction == 0.0


# === unit: slow-worker delay faults ======================================


class TestSlowWorkerInjection:
    def test_targeting_by_node_id(self):
        inj = FaultInjector(task_slow_factor=10.0, slow_workers="w1, w3")
        assert inj.is_slow_node("w1")
        assert inj.is_slow_node("w3")
        assert not inj.is_slow_node("w2")
        assert not inj.is_slow_node(None)

    def test_empty_target_list_slows_every_node(self):
        inj = FaultInjector(task_stall_ms=5.0)
        assert inj.is_slow_node("anything")
        assert inj.is_slow_node(None)

    def test_no_delay_fault_configured(self):
        inj = FaultInjector(task_crash_p=0.5, slow_workers="w1")
        assert not inj.is_slow_node("w1")

    def test_slow_task_sleeps_factor_minus_one(self):
        inj = FaultInjector(task_slow_factor=3.0)
        t0 = time.monotonic()
        inj.slow_task("task:1.0", "w1", execute_s=0.05)
        dt = time.monotonic() - t0
        # 0.05s of "execution" at 3x → 0.10s of extra sleep
        assert 0.08 <= dt <= 1.0
        assert inj.counts.get("task-slow") == 1
        assert inj.events[0]["site"] == "task:1.0"

    def test_slow_task_skips_untargeted_node(self):
        inj = FaultInjector(task_slow_factor=10.0, slow_workers="w1")
        t0 = time.monotonic()
        inj.slow_task("task:1.0", "w2", execute_s=0.5)
        assert time.monotonic() - t0 < 0.1
        assert not inj.events

    def test_stall_task_fixed_delay(self):
        inj = FaultInjector(task_stall_ms=60.0, slow_workers="w1")
        t0 = time.monotonic()
        inj.stall_task("task:0.0", "w1")
        assert time.monotonic() - t0 >= 0.05
        assert inj.counts.get("task-stall") == 1

    def test_from_session_enables_on_delay_only(self):
        s = Session(properties={
            "fault_slow_workers": "worker-1",
            "fault_task_slow_factor": 10.0,
        })
        inj = FaultInjector.from_session(s)
        assert inj is not None
        assert inj.task_slow_factor == 10.0
        assert inj.slow_workers == frozenset({"worker-1"})
        assert FaultInjector.from_session(Session()) is None

    def test_slow_factor_clamped_to_one(self):
        inj = FaultInjector(task_slow_factor=0.25)
        assert inj.task_slow_factor == 1.0
        assert FaultInjector.from_session(
            Session(properties={"fault_task_slow_factor": 0.5})
        ) is None


# === unit: worker-side loser cancellation ================================


def _stalled_task_payload(stall_ms: float):
    """Single Values fragment that stalls ``stall_ms`` before executing
    (empty fault_slow_workers = every node is slow)."""
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.planner.serde import fragment_to_json
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    plan = r.plan("select x + 1 from (values (1),(2),(3)) t(x)")
    sub = fragment_plan(plan)
    return r.engine, {
        "fragment": fragment_to_json(sub.fragment),
        "splits": {},
        "sources": {},
        "session": {"properties": {
            "fault_injection_seed": 1,
            "fault_task_stall_ms": stall_ms,
        }},
    }


class TestLoserCancellation:
    def test_speculative_cancel_mid_stall_never_delivers(self):
        from trino_tpu_torch.server.task import SqlTask

        engine, payload = _stalled_task_payload(stall_ms=1500.0)
        task = SqlTask("cq9.0.0", engine, payload)
        time.sleep(0.2)  # task is asleep inside the injected stall
        task.cancel(speculative=True)
        task._thread.join(timeout=30)
        assert task.state == TaskState.CANCELED_SPECULATIVE
        assert task.state in TERMINAL_TASK_STATES
        res = task.results(0, 0, max_wait=0)
        # the loser of a hedged pair must never double-deliver: the
        # buffer was aborted before the stalled execution could emit
        assert res["failed"] is True
        assert res["pages"] == []
        assert res["complete"] is False

    def test_plain_cancel_is_not_speculative(self):
        from trino_tpu_torch.server.task import SqlTask

        engine, payload = _stalled_task_payload(stall_ms=1000.0)
        task = SqlTask("cq9.0.1", engine, payload)
        time.sleep(0.1)
        task.cancel()
        task._thread.join(timeout=30)
        assert task.state == TaskState.CANCELED

    def test_cancel_after_finish_keeps_finished_state(self):
        from trino_tpu_torch.server.task import SqlTask

        engine, payload = _stalled_task_payload(stall_ms=0.0)
        task = SqlTask("cq9.0.2", engine, payload)
        task._thread.join(timeout=30)
        assert task.state == TaskState.FINISHED
        task.cancel(speculative=True)
        # terminal states survive a late cancel; only the buffer is freed
        assert task.state == TaskState.FINISHED


# === unit: first-finisher-wins dispatch (fake remote tasks) ==============


class _FakeNode:
    def __init__(self, node_id):
        self.node_id = node_id
        self.uri = f"http://{node_id}"
        self.last_announce = time.time()


class _FakeNodeManager:
    def __init__(self, nodes):
        self._nodes = nodes
        self.failure_detector = SimpleNamespace(
            is_failed=lambda node_id: False,
            active_nodes=lambda: [],
        )

    def active_nodes(self):
        return list(self._nodes)


class _FakeTask:
    """Scripted stand-in for HttpRemoteTask: ``script`` is the list of
    status dicts successive polls return (last one repeats). Hedges are
    constructed *inside* ``_await_fragment``, so their script comes from
    the class-level ``hedge_script`` hook; primaries are built by the
    test, which overwrites ``script`` directly."""

    created: list = []
    hedge_script = None  # applied to instances built by the scheduler

    def __init__(self, node, task_id, payload, **http):
        self.node = node
        self.task_id = task_id
        self.payload = payload
        self.attempt = 1
        self.span = None
        self.trace = None
        self.speculative = False
        self.start_error = None
        self._obs_done = False
        self.last_status = None
        self.started_mono = None
        self.cancels: list = []
        self.fake_elapsed_ms = 0.0
        self.script = list(
            _FakeTask.hedge_script
            or [{"state": "FINISHED", "elapsed": 0.01}]
        )
        self._polls = 0
        _FakeTask.created.append(self)

    def start(self):
        self.started_mono = time.monotonic()

    def elapsed_ms(self):
        return self.fake_elapsed_ms

    def status(self, max_wait=0.0):
        st = self.script[min(self._polls, len(self.script) - 1)]
        self._polls += 1
        self.last_status = st
        return st

    def cancel(self, speculative=False):
        self.cancels.append(speculative)


@pytest.fixture()
def fake_cluster(monkeypatch):
    import trino_tpu_torch.server.cluster as cluster_mod

    _FakeTask.created = []
    _FakeTask.hedge_script = None
    monkeypatch.setattr(cluster_mod, "HttpRemoteTask", _FakeTask)
    nodes = [_FakeNode("w0"), _FakeNode("w1")]
    engine = SimpleNamespace(event_listeners=None)
    sched = cluster_mod.ClusterScheduler(engine, _FakeNodeManager(nodes))
    return sched, nodes


def _spec_obs(enabled=True, budget=1):
    return {
        "stage_spans": {},
        "elapsed": {},
        "stage_start": {},
        "spec": SpeculationConfig(
            enabled=enabled, floor_ms=50.0, multiplier=2.0
        ),
        "spec_budget": budget,
        "spec_active": 0,
    }


def _counter_value(outcome):
    from trino_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        "trino_tpu_speculative_attempts_total", outcome=outcome
    ).value


class TestHedgedDispatch:
    def _await(self, sched, tasks, obs, stats=None):
        stats = stats if stats is not None else {}
        sched._await_fragment(
            "cq5", SimpleNamespace(id=0), tasks,
            Session(properties={"retry_initial_delay_ms": 1,
                                "retry_max_delay_ms": 2}),
            stats, {}, obs=obs,
        )
        return stats

    def test_hedge_wins_and_loser_is_cancelled(self, fake_cluster):
        sched, nodes = fake_cluster
        fast = _FakeTask(nodes[0], "cq5.0.0", {})
        fast.script = [{"state": "FINISHED", "elapsed": 0.05}]
        straggler = _FakeTask(nodes[1], "cq5.0.1", {})
        straggler.script = [{"state": "RUNNING"}]
        straggler.fake_elapsed_ms = 10_000.0
        won0, cancelled0 = _counter_value("won"), _counter_value("cancelled")

        tasks = [fast, straggler]
        stats = self._await(sched, tasks, _spec_obs())

        # a hedge was dispatched on the OTHER node and swapped in as winner
        hedge = _FakeTask.created[-1]
        assert hedge is not fast and hedge is not straggler
        assert hedge.task_id == "cq5.0.1s1"
        assert hedge.speculative
        assert hedge.node.node_id != straggler.node.node_id
        assert tasks[1] is hedge
        # first-finisher-wins: the straggling primary was speculatively
        # cancelled, so its buffer aborts and it can never deliver pages
        assert straggler.cancels == [True]
        assert stats["speculative_attempts"] == 1
        assert stats["speculative_wins"] == 1
        assert _counter_value("won") == won0 + 1
        assert _counter_value("cancelled") == cancelled0 + 1

    def test_primary_beats_hedge(self, fake_cluster):
        sched, nodes = fake_cluster
        _FakeTask.hedge_script = [{"state": "RUNNING"}]  # never finishes
        fast = _FakeTask(nodes[0], "cq5.0.0", {})
        fast.script = [{"state": "FINISHED", "elapsed": 0.05}]
        primary = _FakeTask(nodes[1], "cq5.0.1", {})
        # looks slow for two polls, then finishes on its own
        primary.script = [{"state": "RUNNING"}, {"state": "RUNNING"},
                          {"state": "FINISHED", "elapsed": 0.3}]
        primary.fake_elapsed_ms = 10_000.0
        cancelled0 = _counter_value("cancelled")

        tasks = [fast, primary]
        stats = self._await(sched, tasks, _spec_obs())

        hedge = _FakeTask.created[-1]
        assert hedge.speculative
        assert tasks[1] is primary  # primary survived as the winner
        # the hedge lost the race: cancelled speculatively, counted
        assert hedge.cancels == [True]
        assert stats.get("speculative_wins", 0) == 0
        assert stats["speculative_attempts"] == 1
        assert _counter_value("cancelled") == cancelled0 + 1

    def test_budget_caps_concurrent_hedges(self, fake_cluster):
        sched, nodes = fake_cluster
        fast = _FakeTask(nodes[0], "cq5.0.0", {})
        fast.script = [{"state": "FINISHED", "elapsed": 0.05}]
        s1 = _FakeTask(nodes[1], "cq5.0.1", {})
        s2 = _FakeTask(nodes[0], "cq5.0.2", {})
        for s in (s1, s2):
            s.script = [{"state": "RUNNING"}]
            s.fake_elapsed_ms = 10_000.0

        tasks = [fast, s1, s2]
        stats = self._await(sched, tasks, _spec_obs(budget=1))

        # only one hedge fits the per-query budget; once it wins, the
        # freed slot lets the second straggler hedge too — the cap bounds
        # CONCURRENT hedges, not total
        assert stats["speculative_attempts"] >= 1
        assert stats["speculative_wins"] >= 1

    def test_disabled_never_hedges(self, fake_cluster):
        sched, nodes = fake_cluster
        fast = _FakeTask(nodes[0], "cq5.0.0", {})
        fast.script = [{"state": "FINISHED", "elapsed": 0.05}]
        slowish = _FakeTask(nodes[1], "cq5.0.1", {})
        slowish.script = [{"state": "RUNNING"}, {"state": "RUNNING"},
                          {"state": "FINISHED", "elapsed": 0.5}]
        slowish.fake_elapsed_ms = 10_000.0

        tasks = [fast, slowish]
        stats = self._await(
            sched, tasks, _spec_obs(enabled=False, budget=0)
        )
        assert len(_FakeTask.created) == 2  # no hedge constructed
        assert stats.get("speculative_attempts", 0) == 0

    def test_hedge_promoted_when_primary_fails(self, fake_cluster):
        sched, nodes = fake_cluster
        # hedge stays in flight past the primary's death, then finishes
        _FakeTask.hedge_script = [{"state": "RUNNING"},
                                  {"state": "FINISHED", "elapsed": 0.02}]
        fast = _FakeTask(nodes[0], "cq5.0.0", {})
        fast.script = [{"state": "FINISHED", "elapsed": 0.05}]
        doomed = _FakeTask(nodes[1], "cq5.0.1", {})
        doomed.script = [{"state": "RUNNING"}, {"state": "RUNNING"},
                         {"state": "FAILED", "error": "boom",
                          "retryable": True}]
        doomed.fake_elapsed_ms = 10_000.0

        tasks = [fast, doomed]
        stats = self._await(sched, tasks, _spec_obs())

        hedge = _FakeTask.created[-1]
        assert hedge.speculative
        # the in-flight hedge replaced the dead primary: no fresh retry
        # dispatch needed (3 tasks total = no 4th constructed)
        assert tasks[1] is hedge
        assert len(_FakeTask.created) == 3
        assert stats.get("task_retries", 0) == 0


# === unit: QUEUED-but-undispatched hedging ===============================


class TestQueuedHedging:
    """An attempt whose dispatch POST never landed (start_error set) is
    hedged immediately on a different healthy node — no straggler
    threshold, there is nothing running to outwait. The queued twin is
    cancelled (plain, not speculative) when the hedge promotes."""

    def _await(self, sched, tasks, obs, stats=None):
        stats = stats if stats is not None else {}
        sched._await_fragment(
            "cq5", SimpleNamespace(id=0), tasks,
            Session(properties={"retry_initial_delay_ms": 1,
                                "retry_max_delay_ms": 2}),
            stats, {}, obs=obs,
        )
        return stats

    def test_undispatched_task_hedges_without_threshold(self, fake_cluster):
        sched, nodes = fake_cluster
        stuck = _FakeTask(nodes[1], "cq5.0.0", {})
        stuck.start_error = "connection refused"

        tasks = [stuck]
        stats = self._await(sched, tasks, _spec_obs())

        hedge = _FakeTask.created[-1]
        assert hedge is not stuck and hedge.speculative
        assert hedge.task_id == "cq5.0.0s1"
        assert hedge.node.node_id != stuck.node.node_id
        # the instantly-finishing hedge won the race outright: the queued
        # twin is cancelled speculatively before it ever dispatched
        assert tasks[0] is hedge
        assert stuck.cancels == [True]
        assert stats["speculative_attempts"] == 1
        assert stats["speculative_wins"] == 1
        # hedge path, not the backoff/retry path
        assert stats.get("task_retries", 0) == 0

    def test_slow_hedge_promoted_over_queued_twin(self, fake_cluster):
        sched, nodes = fake_cluster
        # hedge still in flight when the twin's start_error is acted on:
        # the promotion path swaps it in with a PLAIN cancel of the twin
        _FakeTask.hedge_script = [{"state": "RUNNING"},
                                  {"state": "FINISHED", "elapsed": 0.02}]
        stuck = _FakeTask(nodes[1], "cq5.0.0", {})
        stuck.start_error = "connection refused"

        tasks = [stuck]
        stats = self._await(sched, tasks, _spec_obs())

        hedge = _FakeTask.created[-1]
        assert hedge.speculative and tasks[0] is hedge
        assert stuck.cancels == [False]
        assert stats["speculative_attempts"] == 1
        assert stats.get("task_retries", 0) == 0

    def test_no_budget_falls_back_to_retry(self, fake_cluster):
        sched, nodes = fake_cluster
        stuck = _FakeTask(nodes[1], "cq5.0.0", {})
        stuck.start_error = "connection refused"

        tasks = [stuck]
        stats = self._await(sched, tasks, _spec_obs(budget=0))

        retry = _FakeTask.created[-1]
        assert not retry.speculative
        assert retry.task_id == "cq5.0.0r1"
        assert tasks[0] is retry
        assert stats.get("speculative_attempts", 0) == 0
        assert stats["task_retries"] == 1

    def test_disabled_speculation_never_hedges_queued(self, fake_cluster):
        sched, nodes = fake_cluster
        stuck = _FakeTask(nodes[1], "cq5.0.0", {})
        stuck.start_error = "connection refused"

        tasks = [stuck]
        stats = self._await(
            sched, tasks, _spec_obs(enabled=False, budget=1)
        )
        assert stats.get("speculative_attempts", 0) == 0
        assert stats["task_retries"] == 1


# === unit: query-completed single-fire under race ========================


class TestFireCompletedRace:
    def test_concurrent_terminal_paths_fire_once(self):
        from trino_tpu_torch.events import EventListener, EventListenerManager
        from trino_tpu_torch.server.querymanager import ManagedQuery

        fired = []

        class Capture(EventListener):
            def query_completed(self, event):
                fired.append(event)

        listeners = EventListenerManager()
        listeners.add(Capture())
        engine = SimpleNamespace(event_listeners=listeners)
        q = ManagedQuery("select 1", Session(), engine=engine)

        start = threading.Barrier(8)

        def fire():
            start.wait()
            q._fire_completed()

        threads = [threading.Thread(target=fire) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        # the stage barrier, cancel(), kill() and the dispatch thread can
        # all reach a terminal state near-simultaneously; exactly one
        # QueryCompletedEvent may escape
        assert len(fired) == 1

    def test_cancel_then_finish_race_fires_once(self):
        from trino_tpu_torch.events import EventListener, EventListenerManager
        from trino_tpu_torch.server.querymanager import ManagedQuery

        fired = []

        class Capture(EventListener):
            def query_completed(self, event):
                fired.append(event)

        listeners = EventListenerManager()
        listeners.add(Capture())
        engine = SimpleNamespace(event_listeners=listeners)
        q = ManagedQuery("select 1", Session(), engine=engine)
        t = threading.Thread(target=q.cancel)
        t.start()
        q._fire_completed()
        t.join(timeout=10)
        assert len(fired) == 1


# === chaos: real cluster with a 10x slow worker ==========================


SLOW_WORKER_PROPS = {
    # speculation needs sibling tasks to hedge against: keep the chain
    # on the per-fragment fan-out path (a fused unit is one task)
    "pipeline_fusion": False,
    "retry_policy": "TASK",
    "fault_injection_seed": 7,
    "fault_slow_workers": "worker-1",
    "fault_task_slow_factor": 10.0,
    # the port's tasks at tpch.tiny run in a few ms on the CPU, so ten
    # times that stays under the 100 ms floor: the slow worker also
    # stalls before executing (the reference's jitted tasks took longer),
    # past the scheduler's 1 s status poll, after which a hedge starts
    "fault_task_stall_ms": 3000,
    "speculation": True,
    "speculation_floor_ms": 100,
    "speculation_multiplier": 2.0,
    "speculation_max_fraction": 1.0,
}

Q1 = """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
              sum(l_extendedprice) as sum_base_price, count(*) as count_order
       from lineitem where l_shipdate <= date '1998-09-02'
       group by l_returnflag, l_linestatus
       order by l_returnflag, l_linestatus"""


# the slow-worker chaos on a cluster runs in test_torch_fault_tolerance.py
# (TestSlowWorkerChaos, on its chaos cluster): this file boots a cluster
# for its slow-marked acceptance only
@pytest.fixture(scope="module")
def spec_cluster():
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    with MultiProcessQueryRunner(n_workers=2, device="cpu") as runner:
        yield runner


def _query_infos(runner):
    import json
    import urllib.request

    from trino_tpu_torch.server import auth

    req = urllib.request.Request(
        f"{runner.coordinator_uri}/v1/query", headers=auth.headers()
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


@pytest.mark.faults
@pytest.mark.slow
class TestSlowWorkerAcceptance:
    """Full acceptance: 5 TPC-H queries, speculation on vs off vs
    single-node, bit-identical everywhere; hedging must claw back a
    measurable share of the 10x-slow-worker wall clock."""

    def test_five_queries_on_off_single_node(self, spec_cluster):
        from tests.test_fault_tolerance import TPCH_CHAOS_QUERIES
        from trino_tpu_torch.testing import LocalQueryRunner

        local = LocalQueryRunner(device="cpu")
        # a fixed 3s stall on top of the 10x factor: the multiplicative
        # slowdown alone is small next to compile/dispatch overheads on
        # tiny data, and the wall-clock comparison needs the slow path
        # to dominate for a robust margin
        on = {**SLOW_WORKER_PROPS, "fault_task_stall_ms": 3000}
        off = {**on, "speculation": False}
        t_on = t_off = 0.0
        for sql in TPCH_CHAOS_QUERIES:
            clean, _ = spec_cluster.execute(sql)
            t0 = time.monotonic()
            hedged, _ = spec_cluster.execute(sql, session_properties=on)
            t_on += time.monotonic() - t0
            t0 = time.monotonic()
            slowed, _ = spec_cluster.execute(sql, session_properties=off)
            t_off += time.monotonic() - t0
            single, _ = local.execute(sql)
            assert hedged == clean, f"speculation changed results: {sql[:50]}"
            assert slowed == clean, f"slow worker changed results: {sql[:50]}"
            assert single == clean, f"single-node differs: {sql[:50]}"
        infos = _query_infos(spec_cluster)
        wins = max(q.get("speculativeWins", 0) for q in infos)
        assert wins >= 1
        # hedging onto the healthy worker must measurably beat waiting
        # out the slow worker. The margin is absolute, not relative:
        # single-task stages can never be hedged (no sibling quorum) and
        # their stalls inflate BOTH sides equally, so the recoverable
        # time is the hedgeable stages' stalls only — ~2-3s per query
        # here, asserted with generous slack for noisy CI wall clocks.
        assert t_off - t_on > 2.0, (
            f"speculation on {t_on:.1f}s not measurably faster than"
            f" off {t_off:.1f}s"
        )


# === the port's own: parity with the reference ===========================


@pytest.mark.parametrize("props", [
    {},
    {"speculation": True},
    {"speculation": True, "speculation_floor_ms": 250, "speculation_multiplier": 3.0,
     "speculation_max_fraction": 0.5},
    {"speculation": True, "speculation_multiplier": 0.5, "speculation_max_fraction": -1},
])
def test_detector_and_slow_targets_equal_the_reference(props):
    """``SpeculationConfig`` from the same session gives the reference's
    thresholds and budgets, and the slow-worker targeting of the same
    injector settings picks the same nodes."""
    from trino_tpu.config import Session as RefSession
    from trino_tpu.ft.injection import FaultInjector as RefInjector
    from trino_tpu.ft.retry import SpeculationConfig as RefConfig

    port = SpeculationConfig.from_session(Session(properties=dict(props)))
    ref = RefConfig.from_session(RefSession(properties=dict(props)))
    samples = [[], [5.0], [5.0, 80.0, 120.0], [400.0] * 7]
    assert [port.threshold_ms(s) for s in samples] == [ref.threshold_ms(s) for s in samples]
    assert [port.budget(n) for n in (0, 1, 7, 40)] == [ref.budget(n) for n in (0, 1, 7, 40)]
    for targets in ("", "worker-1", " worker-0 , worker-2"):
        pi = FaultInjector(task_slow_factor=4.0, slow_workers=targets)
        ri = RefInjector(task_slow_factor=4.0, slow_workers=targets)
        nodes = ("worker-0", "worker-1", "worker-2", None)
        assert [pi.is_slow_node(n) for n in nodes] == [ri.is_slow_node(n) for n in nodes]
