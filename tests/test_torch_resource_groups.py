"""Resource groups of trino_tpu_torch: hierarchy, admission, queueing,
policies.

The cases of ``tests/test_resource_groups.py`` on the port's resource
groups and server (``device="cpu"``), and the device-memory gate
(``_hbm_fits``) admitting on a CPU device. The reference's docstring
follows.

Mirrors reference tests ``execution/resourcegroups/TestInternalResourceGroup``
and ``execution/TestQueues.java``.
"""

import threading
import time

import pytest
import torch

from trino_tpu_torch.server.resourcegroups import (
    GroupConfig,
    QueryQueueFullError,
    ResourceGroupManager,
    Selector,
)

from torch_server_fixtures import port_loop_under_lockdep  # noqa: F401

torch.set_num_threads(1)


def make_manager(limit=1, queued=2, wait=5.0) -> ResourceGroupManager:
    mgr = ResourceGroupManager(max_wait_seconds=wait)
    mgr.configure(
        [GroupConfig("root", max_queued=queued, hard_concurrency_limit=limit)],
        [Selector(group="root")],
    )
    return mgr


class TestAdmission:
    def test_admit_and_finish(self):
        mgr = make_manager(limit=2)
        g1 = mgr.admit("alice")
        g2 = mgr.admit("bob")
        assert g1.running == 2
        mgr.finish(g1)
        assert g1.running == 1

    def test_blocks_until_slot_frees(self):
        mgr = make_manager(limit=1)
        g = mgr.admit("alice")
        admitted = threading.Event()

        def second():
            mgr.admit("bob")
            admitted.set()

        t = threading.Thread(target=second)
        t.start()
        time.sleep(0.1)
        assert not admitted.is_set()  # queued
        mgr.finish(g)
        assert admitted.wait(2.0)
        t.join()

    def test_queue_full_rejects(self):
        mgr = make_manager(limit=1, queued=1, wait=0.2)
        mgr.admit("a")
        t = threading.Thread(target=lambda: _swallow(mgr))
        t.start()
        time.sleep(0.05)  # first waiter occupies the queue
        with pytest.raises(QueryQueueFullError):
            mgr.admit("c")
        t.join()

    def test_wait_timeout(self):
        mgr = make_manager(limit=1, wait=0.1)
        mgr.admit("a")
        with pytest.raises(QueryQueueFullError):
            mgr.admit("b")

    def test_fifo_order(self):
        mgr = make_manager(limit=1, queued=10)
        g = mgr.admit("first")
        order = []
        threads = []
        for name in ("q1", "q2", "q3"):
            def run(n=name):
                grp = mgr.admit(n)
                order.append(n)
                mgr.finish(grp)

            t = threading.Thread(target=run)
            t.start()
            threads.append(t)
            time.sleep(0.05)  # deterministic enqueue order
        mgr.finish(g)
        for t in threads:
            t.join(5)
        assert order == ["q1", "q2", "q3"]


class TestHierarchy:
    def test_per_user_template_subgroups(self):
        mgr = ResourceGroupManager(max_wait_seconds=0.2)
        mgr.configure(
            [
                GroupConfig(
                    "global",
                    hard_concurrency_limit=2,
                    subgroups=[],
                )
            ],
            [Selector(group="global.${USER}")],
        )
        ga = mgr.admit("alice")
        gb = mgr.admit("bob")
        assert ga.full_name == "global.alice"
        assert gb.full_name == "global.bob"
        # parent limit (2) reached: third user queues then times out
        with pytest.raises(QueryQueueFullError):
            mgr.admit("carol")

    def test_selector_user_pattern(self):
        mgr = ResourceGroupManager()
        mgr.configure(
            [
                GroupConfig("admin", hard_concurrency_limit=5),
                GroupConfig("other", hard_concurrency_limit=5),
            ],
            [
                Selector(group="admin", user_pattern="admin_.*"),
                Selector(group="other"),
            ],
        )
        assert mgr.admit("admin_joe").full_name == "admin"
        assert mgr.admit("someone").full_name == "other"

    def test_from_config_json_shape(self):
        mgr = ResourceGroupManager.from_config(
            {
                "rootGroups": [
                    {
                        "name": "global",
                        "hardConcurrencyLimit": 7,
                        "maxQueued": 3,
                        "schedulingPolicy": "weighted_fair",
                        "subGroups": [
                            {"name": "adhoc", "schedulingWeight": 1},
                            {"name": "etl", "schedulingWeight": 4},
                        ],
                    }
                ],
                "selectors": [
                    {"user": "etl_.*", "group": "global.etl"},
                    {"group": "global.adhoc"},
                ],
            }
        )
        g = mgr.admit("etl_job")
        assert g.full_name == "global.etl"
        info = mgr.info()
        assert info[0]["hardConcurrencyLimit"] == 7


class TestServerIntegration:
    def test_server_enforces_concurrency(self):
        from trino_tpu_torch.client import Connection
        from trino_tpu_torch.server.http import TrinoTpuServer

        rgm = ResourceGroupManager(max_wait_seconds=30)
        rgm.configure(
            [GroupConfig("root", max_queued=10, hard_concurrency_limit=1)],
            [Selector(group="root")],
        )
        s = TrinoTpuServer(resource_groups=rgm, device="cpu").start()
        try:
            results = []

            def run(i):
                c = Connection(s.base_uri)
                rows, _ = c.execute(f"select {i}")
                results.append(rows[0][0])

            threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert sorted(results) == [0, 1, 2, 3]
            info = rgm.info()[0]
            assert info["runningQueries"] == 0
        finally:
            s.stop()

    def test_resource_group_endpoint(self):
        import json
        import urllib.request

        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(device="cpu").start()
        try:
            with urllib.request.urlopen(f"{s.base_uri}/v1/resourceGroup") as r:
                info = json.loads(r.read().decode())
            assert info and info[0]["id"]
        finally:
            s.stop()


class TestDeviceMemoryGate:
    """The peak-memory hint gates admission on the card's free memory; a
    CPU device (no memory accounting) and a manager without a device
    admit, as the reference admits on a backend without memory stats."""

    def test_cpu_device_admits_any_hint(self):
        mgr = make_manager(limit=2)
        mgr.device = torch.device("cpu")
        assert mgr._hbm_fits(1 << 62)
        group, admitted = mgr.submit("alice", "", lambda g, e: None,
                                     peak_hbm_hint=1 << 62)
        assert admitted and group.running == 1

    def test_no_device_and_no_hint_admit(self):
        mgr = make_manager()
        assert mgr.device is None and mgr._hbm_fits(1 << 62)
        mgr.device = torch.device("cpu")
        assert mgr._hbm_fits(0)

    def test_server_gates_on_its_engines_device(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(device="cpu")
        try:
            assert s.resource_groups.device == torch.device("cpu")
        finally:
            s.stop()


def _swallow(mgr):
    try:
        mgr.admit("b")
    except QueryQueueFullError:
        pass
