"""Observability: the span tracer and the metrics registry.

Copies of ``trino_tpu/obs/trace.py`` and ``trino_tpu/obs/metrics.py``:

- :mod:`trino_tpu_torch.obs.trace` — structured spans. Trace id = query
  id; emission is a no-op unless a sink is registered (the server
  registers one). The server's query root spans are what this package
  emits; the engine's and the executors' spans, the device profiler, the
  flight journal, the SLO sentinel and the history store are ROADMAP
  item 9b.
- :mod:`trino_tpu_torch.obs.metrics` — process-global counters, gauges
  and fixed-bucket histograms, rendered in Prometheus text format at
  ``GET /v1/metrics`` and read by ``system.runtime.metrics``. Names stay
  the reference's (``trino_tpu_*``): dashboards read them.
"""

from trino_tpu_torch.obs.metrics import get_registry
from trino_tpu_torch.obs.trace import InMemorySpanSink, get_tracer

__all__ = ["get_registry", "get_tracer", "InMemorySpanSink"]
