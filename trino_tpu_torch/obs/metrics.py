"""Dependency-free metrics registry: counters, gauges, histograms.

Mirrors the role of the reference engine's JMX beans: a process-global
registry each server exposes at ``GET /v1/metrics`` in Prometheus text
exposition format (``?format=json`` returns :meth:`MetricsRegistry.snapshot`
for embedding in bench/chaos JSON lines).

Histograms use fixed upper-bound buckets (milliseconds by default) so
aggregation across scrapes is exact on counts and approximate on
quantiles (linear interpolation within the bucket) — the standard
Prometheus trade. Exact per-query quantiles (the speculative-execution
straggler signal) come instead from :func:`percentile` over the live
per-stage sibling elapsed lists the coordinator keeps while a stage
runs.

A copy of ``trino_tpu/obs/metrics.py``; the metric names stay the
reference's (``trino_tpu_*``), which dashboards and tests read.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# upper bounds in ms; +inf is implicit
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0, 300000.0,
)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Exact linear-interpolated percentile (q in [0, 100]) of a small
    sample, e.g. sibling task elapsed within one stage."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return float(vs[0])
    rank = (q / 100.0) * (len(vs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return float(vs[lo] + (vs[hi] - vs[lo]) * frac)


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS) -> None:
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last = +inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            i = 0
            for i, ub in enumerate(self.buckets):  # noqa: B007
                if value <= ub:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile (q in [0, 100]) by interpolating within
        the bucket containing the target rank."""
        with self._lock:
            if self.count == 0:
                return None
            target = (q / 100.0) * self.count
            cum = 0
            lo = 0.0
            for i, ub in enumerate(self.buckets):
                prev = cum
                cum += self.counts[i]
                if cum >= target:
                    if self.counts[i] == 0:
                        return ub
                    frac = (target - prev) / self.counts[i]
                    return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
                lo = ub
            return self.buckets[-1] if self.buckets else None


class MetricsRegistry:
    """Labelled metric families keyed by (name, sorted label items)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._types: Dict[str, str] = {}
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any], factory):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            existing_kind = self._types.get(name)
            if existing_kind is None:
                self._types[name] = kind
            elif existing_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing_kind}"
                )
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = factory()
            return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
        **labels: Any,
    ) -> Histogram:
        return self._get("histogram", name, labels, lambda: Histogram(buckets))

    def reset(self) -> None:
        with self._lock:
            self._types.clear()
            self._metrics.clear()

    # -- rendering ------------------------------------------------------
    @staticmethod
    def _escape_label_value(v: Any) -> str:
        """Prometheus text-format label escaping: backslash, double quote,
        and line feed must be escaped inside label values (exposition
        format 0.0.4) — fragment labels carry repr()'d program keys that
        can contain quotes."""
        return (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    @classmethod
    def _label_str(
        cls, labels: Tuple[Tuple[str, str], ...], extra: str = ""
    ) -> str:
        parts = [f'{k}="{cls._escape_label_value(v)}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
            types = dict(self._types)
        lines: List[str] = []
        seen_type: set = set()
        for (name, labels), metric in items:
            kind = types.get(name, "counter")
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                cum = 0
                lo_labels = labels
                for i, ub in enumerate(metric.buckets):
                    cum += metric.counts[i]
                    ls = self._label_str(lo_labels, f'le="{ub:g}"')
                    lines.append(f"{name}_bucket{ls} {cum}")
                cum += metric.counts[-1]
                ls = self._label_str(lo_labels, 'le="+Inf"')
                lines.append(f"{name}_bucket{ls} {cum}")
                ls = self._label_str(lo_labels)
                lines.append(f"{name}_sum{ls} {metric.sum:g}")
                lines.append(f"{name}_count{ls} {metric.count}")
            else:
                ls = self._label_str(labels)
                lines.append(f"{name}{ls} {metric.value:g}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe dump for bench/chaos output: flat name{labels} keys."""
        with self._lock:
            items = sorted(self._metrics.items())
            types = dict(self._types)
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), metric in items:
            kind = types.get(name, "counter")
            key = name + self._label_str(labels)
            if kind == "histogram":
                out["histograms"][key] = {
                    "count": metric.count,
                    "sum": round(metric.sum, 3),
                    "p50": metric.quantile(50),
                    "p99": metric.quantile(99),
                }
            elif kind == "gauge":
                out["gauges"][key] = metric.value
            else:
                out["counters"][key] = metric.value
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
