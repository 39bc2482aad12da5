"""trino_tpu_torch — the SQL engine on PyTorch and CUDA (one NVIDIA H100).

The same engine as ``trino_tpu`` (parser, analyzer, planner, fragmenter,
executors), with the device tier written in PyTorch and every Pallas
kernel rewritten by hand for Hopper in CUDA C++ (``csrc/``).

Device policy: every entry point (``Engine``, ``LocalQueryRunner``, the
kernel wrappers) takes an explicit ``device`` that defaults to ``cuda``.
Without a GPU the entry points raise unless the caller passes
``device="cpu"`` — nothing carries on quietly on the host. int64 is used
throughout; there is no global precision switch.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch device an entry point runs on: ``cuda`` unless the caller
    names another one; raises when CUDA is asked for and absent."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "trino_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host"
        )
    return dev
