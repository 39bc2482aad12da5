"""Unified lint entry point: host reads (JIT*) + concurrency (CONC/LOOP/LOCK/THRD)
+ metric hygiene (OBS*).

The check families share one suppression baseline (``baseline.json``)
and one CLI; ``--only`` narrows to a single family and ``--stats``
prints per-rule counts of the full (pre-baseline) violation set.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Optional

from trino_tpu_torch.lint import concurrency, jit_safety, obs_metrics
from trino_tpu_torch.lint.jit_safety import (
    BASELINE_PATH,
    DEFAULT_PATHS,
    Violation,
    compare_to_baseline,
    load_baseline,
    to_baseline,
)

FAMILIES = {
    "jit": jit_safety.lint_paths,
    "concurrency": concurrency.lint_paths,
    "obs": obs_metrics.lint_paths,
}


def lint_all(paths, only: Optional[str] = None) -> list[Violation]:
    out: list[Violation] = []
    for name, fn in FAMILIES.items():
        if only is None or only == name:
            out.extend(fn(paths))
    return sorted(out, key=lambda v: (v.path, v.lineno, v.rule))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.lint",
        description="static analysis: torch host reads + concurrency "
        "discipline (see trino_tpu_torch/lint/)",
    )
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS))
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH)
    ap.add_argument(
        "--only", choices=sorted(FAMILIES),
        help="run a single check family",
    )
    ap.add_argument(
        "--stats", action="store_true",
        help="print per-rule violation counts (before baseline filtering)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="report every violation, ignoring the suppression baseline",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current violation set and exit 0",
    )
    args = ap.parse_args(argv)

    violations = lint_all(args.paths, only=args.only)

    if args.stats:
        counts = Counter(v.rule for v in violations)
        for rule, n in sorted(counts.items()):
            print(f"{rule}: {n}")
        print(f"total: {len(violations)}")

    if args.update_baseline:
        if args.only:
            # the baseline always covers every family — a partial run
            # must not drop the other family's entries
            violations = lint_all(args.paths)
        fresh = to_baseline(violations)
        if args.baseline.exists():  # keep human-written per-entry notes
            old = json.loads(args.baseline.read_text())
            if "notes" in old:
                fresh["notes"] = old["notes"]
        args.baseline.write_text(json.dumps(fresh, indent=2) + "\n")
        print(
            f"baseline updated: {len(violations)} suppressed violations "
            f"-> {args.baseline}"
        )
        return 0

    baseline = (
        {"version": 1, "entries": {}}
        if args.no_baseline
        else load_baseline(args.baseline)
    )
    if args.only:
        # compare only against this family's slice of the baseline
        prefixes = {
            "jit": ("JIT",),
            "concurrency": ("CONC", "LOOP", "LOCK", "THRD"),
            "obs": ("OBS",),
        }
        keep = prefixes[args.only]
        baseline = {
            "version": baseline.get("version", 1),
            "entries": {
                k: n
                for k, n in baseline.get("entries", {}).items()
                if k.split("::")[1].startswith(keep)
            },
        }
    new, stale = compare_to_baseline(violations, baseline)
    for v in new:
        print(v.render())
    for k in stale:
        print(f"note: stale baseline entry (violation fixed?): {k}")
    if new:
        print(
            f"\n{len(new)} new violation(s) "
            f"({len(violations)} total, {len(violations) - len(new)} baselined)"
        )
        return 1
    print(f"clean: 0 new violations ({len(violations)} baselined)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
