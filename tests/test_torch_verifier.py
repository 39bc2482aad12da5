"""The port's query verifier (``trino_tpu_torch/verifier.py``) against the
reference's (``trino_tpu/verifier.py``): the same normalization, the same
report on the same runners, and the port's engines agreeing with each
other at ``tpch.tiny`` on the CPU, in process and over a coordinator."""

import datetime
import re
from decimal import Decimal

import numpy as np
import pytest
import torch

from torch_server_fixtures import port_loop_under_lockdep  # noqa: F401
from trino_tpu import verifier as ref_verifier
from trino_tpu_torch import verifier

# the two queries of tests/test_server.py::TestVerifier
QUERIES = [
    "select o_orderpriority, count(*) from tpch.tiny.orders group by 1",
    "select count(*) from tpch.tiny.nation n join tpch.tiny.region r "
    "on n.n_regionkey = r.r_regionkey",
]


def _seeded_rows(seed: int, n: int = 40) -> list[tuple]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        cents = int(rng.integers(-10**6, 10**6))
        rows.append((
            Decimal(cents).scaleb(-2),
            float(rng.standard_normal()),
            int(rng.integers(-5, 5)),
            None if rng.random() < 0.3 else str(rng.integers(0, 9)),
            datetime.date(1992, 1, 1) + datetime.timedelta(days=int(rng.integers(0, 2500))),
        ))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_equals_the_references(seed):
    rows = _seeded_rows(seed)
    assert verifier._normalize(rows) == ref_verifier._normalize(rows)
    assert verifier._normalize(rows[::-1]) == verifier._normalize(rows)


def _report(module, monkeypatch, capsys, control_rows, test_rows):
    """``verify`` with the reference test's fake runners
    (``tests/test_server.py::TestVerifier``): its failure count and its
    printed lines with the timings stripped."""

    def fake_runner(spec, device=None):
        def run(sql):
            if "boom" in sql:
                raise RuntimeError("boom")
            return control_rows if spec == "local" else test_rows

        return run

    monkeypatch.setattr(module, "_runner_for", fake_runner)
    n = module.verify("local", "distributed", ["select 1", " ", "select boom"])
    out = re.sub(r"\d+\.\d+s", "<t>", capsys.readouterr().out)
    return n, out


@pytest.mark.parametrize("rows", [([(1,)], [(2,)]), ([(1,), (2,)], [(2,), (1,)])])
def test_verify_reports_as_the_reference(monkeypatch, capsys, rows):
    port = _report(verifier, monkeypatch, capsys, *rows)
    ref = _report(ref_verifier, monkeypatch, capsys, *rows)
    assert port == ref
    assert port[0] == (2 if rows[0] != rows[1] and sorted(rows[0]) != sorted(rows[1]) else 1)


def test_local_vs_distributed_on_the_port():
    assert verifier.verify("local", "distributed", QUERIES, device="cpu") == 0


def test_coordinator_uri_as_control():
    from trino_tpu_torch.server.http import TrinoTpuServer

    server = TrinoTpuServer(device="cpu")
    server.start()
    try:
        assert verifier.verify(server.base_uri, "distributed", QUERIES[1:], device="cpu") == 0
    finally:
        server.stop()


def test_cli_exit_codes(tmp_path, monkeypatch, capsys):
    good = tmp_path / "good.sql"
    good.write_text(QUERIES[1] + ";\n")
    bad = tmp_path / "bad.sql"
    bad.write_text(QUERIES[1] + ";\nselect * from tpch.tiny.no_such_table;\n")
    args = ["--control", "local", "--test", "distributed", "--device", "cpu"]
    assert verifier.main(args + ["--queries", str(good)]) == 0
    assert verifier.main(args + ["--queries", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "1 queries, 0 failures" in out and "2 queries, 1 failures" in out
    assert "ERROR" in out
    # the card by default: without one it raises, never runs on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.main(args[:4] + ["--queries", str(good)])
