"""Static analysis for the port (``python -m trino_tpu_torch.lint``).

Three rule families share one harness (baseline, inline suppressions,
CLI):

- ``jit_safety.py`` — JIT### rules: host reads of CUDA tensors (the
  card synchronized from Python, a capture broken) and DOUBLE narrowing.
- ``concurrency.py`` — CONC/LOCK/LOOP/THRD rules: blocking calls and
  callback fires under locks, lock-order inversions, blocking ops
  reachable from the event loop, daemon threads without a shutdown
  path.
- ``obs_metrics.py`` — OBS rules: unbounded metric labels and names.

``lockdep.py`` is the runtime complement: a lock-order and loop-thread
wait validator, installed by a caller (``install()``) and read with
``report()``; the port's event loop registers its threads with it.

See ``baseline.json`` for the suppression baseline: CI fails only on
violations *new* relative to the baseline, so pre-existing debt is
visible but non-blocking; every entry carries a justification under
``notes``.
"""

from trino_tpu_torch.lint import concurrency, lockdep, obs_metrics  # noqa: F401
from trino_tpu_torch.lint.cli import FAMILIES, lint_all, main  # noqa: F401
from trino_tpu_torch.lint.jit_safety import (  # noqa: F401
    DEFAULT_PATHS,
    Violation,
    compare_to_baseline,
    lint_paths,
    load_baseline,
    to_baseline,
)
from trino_tpu_torch.lint.jit_safety import RULES as _JIT_RULES

RULES = {**_JIT_RULES, **concurrency.RULES, **obs_metrics.RULES}
