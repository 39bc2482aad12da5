"""trino_tpu_torch stands alone: no JAX, nothing of trino_tpu, and no
silent fallback to the CPU.

The import check runs in a fresh interpreter so that this test process's
own JAX import (tests/conftest.py) cannot mask a leak.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import trino_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            trino_tpu_torch.__path__, "trino_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # the GPU smoke script: torch only, too
        leaked = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m == "jaxlib" or m.startswith("jaxlib.")
            or m == "trino_tpu" or m.startswith("trino_tpu.")
        )
        print(",".join(names))
        print(",".join(leaked))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.splitlines()[-2:]
    names = names.split(",")
    assert len(names) >= 20  # every module of the package was imported
    for module in ("connectors.tpch", "connectors.dbgen", "benchmarks.tpch",
                   "ops.decimal128", "exec.streaming", "native", "strings",
                   "connectors.tpcds", "benchmarks.tpcds", "ops.window",
                   "ingest", "memory", "spill"):
        assert f"trino_tpu_torch.{module}" in names
    assert leaked == ""


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.testing import LocalQueryRunner

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalQueryRunner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(device="cuda")
    assert Engine(device="cpu").device == torch.device("cpu")
    assert LocalQueryRunner(device="cpu").engine.device.type == "cpu"


def test_kernel_wrapper_never_falls_back_for_cuda_tensors():
    """A CUDA tensor goes to the kernel or raises; only CPU tensors take
    the plain version. Here that shows as: a non-CPU, non-CUDA tensor is
    refused rather than run on the host."""
    from trino_tpu_torch.ops import dense_groupby as D

    plan = D.DensePlan(G=128, cols=(D.DenseCol(True, 8),), pair128=(False,))
    bins = torch.zeros(16, dtype=torch.int32, device="meta")
    vals = [torch.zeros(16, dtype=torch.int64, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        D.dense_groupby_device(plan, bins, vals)
