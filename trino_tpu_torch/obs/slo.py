"""SLO regression sentinel: history-baselined completion checks.

Copy of ``trino_tpu/obs/slo.py``. The history store
(``obs/history.py``) keeps per-fingerprint elapsed percentiles; the
sentinel acts on them at query completion, on the thread that just
recorded history:

- **absolute SLO** — ``slo_elapsed_ms`` (session prop; 0 = off): any
  completion slower than the target counts
  ``trino_tpu_slo_violations_total``.
- **relative regression** — once a fingerprint's baseline holds at least
  ``slo_min_samples`` elapsed samples, a completion slower than
  ``slo_regression_multiplier`` x the baseline p50 fires a regression
  (severity ``minor``, or ``severe`` past ``slo_severe_multiplier``),
  counted by ``trino_tpu_query_regressions_total{severity}``. A
  subsequent in-bounds completion clears the fingerprint.

Verdicts are returned to the engine (surfaced as
``queryStats.regression``) and retained per fingerprint for
``GET /v1/slo``. Evaluation reads the PRE-run history entry, so the
baseline is never contaminated by the run being judged. Best-effort by
contract: the sentinel must never fail or slow the query that feeds it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional


def _percentile(xs: list, p: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return float(ys[min(len(ys) - 1, int(p / 100.0 * len(ys)))])


class SloSentinel:
    """Thread-safe regression/violation tracker (one per process)."""

    def __init__(self, max_entries: int = 256):
        self._lock = threading.Lock()
        self._regressed: dict[str, dict] = {}
        self._max_entries = max(1, int(max_entries))
        self.violations = 0
        self.regressions = 0
        self.evaluations = 0

    # --- evaluate ---------------------------------------------------------

    def evaluate(
        self,
        session,
        fingerprint: Optional[str],
        elapsed_ms: float,
        history_entry: Optional[dict],
        query_id: Optional[str] = None,
    ) -> Optional[dict]:
        """Judge one completion. Returns the verdict dict attached to
        ``queryStats.regression`` (None = within baseline / cold / off)."""
        try:
            slo_ms = float(session.get("slo_elapsed_ms"))
            reg_mult = float(session.get("slo_regression_multiplier"))
            sev_mult = float(session.get("slo_severe_multiplier"))
            min_samples = int(session.get("slo_min_samples"))
        except (KeyError, TypeError, ValueError):
            return None
        elapsed_ms = float(elapsed_ms)
        verdict: dict[str, Any] = {}
        reg = self._registry()
        with self._lock:
            self.evaluations += 1
        if slo_ms > 0 and elapsed_ms > slo_ms:
            verdict["sloViolation"] = 1
            verdict["sloElapsedMs"] = slo_ms
            with self._lock:
                self.violations += 1
            if reg is not None:
                reg.counter("trino_tpu_slo_violations_total").inc()
        samples = list((history_entry or {}).get("elapsed_samples") or [])
        p50 = _percentile(samples, 50)
        if fingerprint and len(samples) >= min_samples and p50 > 0:
            magnitude = elapsed_ms / p50
            if magnitude >= reg_mult:
                severity = "severe" if magnitude >= sev_mult else "minor"
                verdict.update(
                    regressed=1,
                    severity=severity,
                    magnitude=round(magnitude, 3),
                    baselineP50Ms=round(p50, 3),
                    baselineP90Ms=round(_percentile(samples, 90), 3),
                    baselineSamples=len(samples),
                )
                with self._lock:
                    self.regressions += 1
                    self._regressed[fingerprint] = {
                        "fingerprint": fingerprint,
                        "queryId": query_id,
                        "elapsedMs": round(elapsed_ms, 3),
                        "baselineP50Ms": round(p50, 3),
                        "magnitude": round(magnitude, 3),
                        "severity": severity,
                        "ts": time.time(),
                    }
                    self._evict_locked()
                if reg is not None:
                    reg.counter(
                        "trino_tpu_query_regressions_total",
                        severity=severity,
                    ).inc()
            else:
                # recovered: an in-bounds completion clears the flag
                with self._lock:
                    self._regressed.pop(fingerprint, None)
        if not verdict:
            return None
        verdict["elapsedMs"] = round(elapsed_ms, 3)
        return verdict

    def _evict_locked(self) -> None:
        while len(self._regressed) > self._max_entries:
            oldest = min(
                self._regressed,
                key=lambda fp: self._regressed[fp].get("ts", 0.0),
            )
            self._regressed.pop(oldest, None)

    @staticmethod
    def _registry():
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            return get_registry()
        except Exception:  # noqa: BLE001
            return None

    # --- read -------------------------------------------------------------

    def snapshot(self) -> dict:
        """``GET /v1/slo`` body: currently-regressed fingerprints with
        magnitudes, newest first, plus process counters."""
        with self._lock:
            rows = sorted(
                self._regressed.values(),
                key=lambda r: -float(r.get("ts", 0.0)),
            )
            return {
                "regressed": [dict(r) for r in rows],
                "violations": self.violations,
                "regressions": self.regressions,
                "evaluations": self.evaluations,
            }

    def reset(self) -> None:
        with self._lock:
            self._regressed.clear()
            self.violations = self.regressions = self.evaluations = 0


_SENTINEL = SloSentinel()


def get_sentinel() -> SloSentinel:
    return _SENTINEL
