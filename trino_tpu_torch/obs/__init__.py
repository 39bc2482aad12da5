"""Observability: spans, metrics, the device profiler, query history,
the SLO sentinel and the flight journal.

Copies of ``trino_tpu/obs/`` (the profiler a counterpart):

- :mod:`trino_tpu_torch.obs.trace` — structured spans. Trace id = query
  id; emission is a no-op unless a sink is registered (the server
  registers one).
- :mod:`trino_tpu_torch.obs.metrics` — process-global counters, gauges
  and fixed-bucket histograms, rendered in Prometheus text format at
  ``GET /v1/metrics`` and read by ``system.runtime.metrics``. Names stay
  the reference's (``trino_tpu_*``): dashboards read them.
- :mod:`trino_tpu_torch.obs.profiler` — each captured program's CUDA
  allocator numbers (argument, output, pool and peak bytes), rolled up a
  query as ``deviceStats``.
- :mod:`trino_tpu_torch.obs.history` — the per-fingerprint query-history
  store: capacity seeds, the admission gate's peak, ``GET /v1/history``.
- :mod:`trino_tpu_torch.obs.slo` — the SLO regression sentinel
  (``GET /v1/slo``).
- :mod:`trino_tpu_torch.obs.flight` — the crash-safe lifecycle journal
  (``GET /v1/query/{id}/flight``).
"""

from trino_tpu_torch.obs.flight import FlightRecorder, replay_dir
from trino_tpu_torch.obs.history import HistoryHbmRejected, QueryHistoryStore
from trino_tpu_torch.obs.metrics import get_registry
from trino_tpu_torch.obs.profiler import merge_device_stats, rollup_device_stats
from trino_tpu_torch.obs.slo import SloSentinel, get_sentinel
from trino_tpu_torch.obs.trace import InMemorySpanSink, get_tracer

__all__ = [
    "get_registry", "get_tracer", "InMemorySpanSink", "QueryHistoryStore",
    "HistoryHbmRejected", "SloSentinel", "get_sentinel", "FlightRecorder",
    "replay_dir", "rollup_device_stats", "merge_device_stats",
]
