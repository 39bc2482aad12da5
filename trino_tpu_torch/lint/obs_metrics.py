"""AST lint for metrics label-cardinality discipline (OBS rules).

Prometheus time series are keyed by the full label set: every distinct
label VALUE mints a new series that lives in the registry (and every
scraper) forever. A label fed from an unbounded domain — a query id, a
fingerprint, a SQL string, a trace id — grows the registry linearly
with traffic until the process (or the Prometheus server) falls over.
The same applies to metric NAMES built from runtime strings.

- ``OBS001`` unbounded label value — a ``counter()``/``gauge()``/
  ``histogram()`` label kwarg whose value is built at runtime from an
  open domain: an f-string, ``%``-format, ``.format()``/``str()`` call,
  or an identifier whose name says it carries per-query identity
  (query id, fingerprint, sql, trace/span id, uri, user...). Closed
  vocabularies pass: string literals, plain variables with innocuous
  names (``state``, ``severity``, ``kind``), and subscripts like
  ``record["state"]``.
- ``OBS002`` dynamic metric name — the metric-name argument is an
  f-string / ``%`` / ``.format()`` expression. Legitimate only for a
  provably closed vocabulary; suppress those sites with
  ``# lint: ignore[OBS002]`` and say why.

Scope heuristic: any call of a method named ``counter``/``gauge``/
``histogram`` whose first argument is a string (literal or built) —
this is the MetricsRegistry surface (obs/metrics.py) everywhere in the
repo. Violations key against the shared lint baseline; an inline
``# lint: ignore[OBS00x]`` comment suppresses a single line.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable

from trino_tpu_torch.lint.jit_safety import Violation, _rel, parse_file

RULES = {
    "OBS001": "unbounded metrics label value: per-query identity in a "
    "label mints one Prometheus series per query",
    "OBS002": "dynamically built metric name: runtime strings mint "
    "unbounded metric families",
}

_METRIC_METHODS = frozenset({"counter", "gauge", "histogram"})

# histogram(name, buckets=...) — structural kwargs, not labels
_NON_LABEL_KWARGS = frozenset({"buckets"})

# identifier substrings that say "this value is per-query / unbounded";
# matching is case-insensitive over the full dotted/subscripted source
# of the expression
_IDENTITY_RE = re.compile(
    r"(query_?id|queryid|trace_?id|span_?id|fingerprint|\bsql\b"
    r"|statement|\buri\b|\burl\b|\buser\b|session_?id|task_?id"
    r"|slug|token|message|error_?msg)",
    re.IGNORECASE,
)


def _is_dynamic_string(node: ast.expr) -> bool:
    """Built-at-runtime string: f-string, %-format, .format(), str()."""
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "format":
            return True
        if isinstance(fn, ast.Name) and fn.id in ("str", "repr"):
            return True
    return False


def _expr_source(node: ast.expr) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — lint must not crash on exotic AST
        return ""


def _suspicious_label(node: ast.expr) -> str:
    """Why this label value is unbounded ('' = it is fine)."""
    if _is_dynamic_string(node):
        return "runtime-built string"
    # literals and simple closed-vocabulary reads are fine unless the
    # expression's own identifiers say "per-query identity"
    if isinstance(node, ast.Constant):
        return ""
    src = _expr_source(node)
    if src and _IDENTITY_RE.search(src):
        return f"identity-bearing expression {src!r}"
    return ""


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, source_lines: list[str]):
        self.path = path
        self.lines = source_lines
        self.stack: list[str] = []
        self.out: list[Violation] = []

    def _func(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def _suppressed(self, lineno: int, rule: str) -> bool:
        if 1 <= lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            return f"lint: ignore[{rule}]" in line or "lint: ignore-all" in line
        return False

    def _flag(self, node: ast.AST, rule: str, detail: str) -> None:
        lineno = getattr(node, "lineno", 0)
        if self._suppressed(lineno, rule):
            return
        self.out.append(
            Violation(
                self.path, rule, self._func(), lineno,
                RULES[rule] + (f" ({detail})" if detail else ""),
            )
        )

    def visit_FunctionDef(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _METRIC_METHODS
            and node.args
        ):
            name_arg = node.args[0]
            name_is_str = isinstance(name_arg, ast.Constant) and isinstance(
                name_arg.value, str
            )
            if name_is_str or _is_dynamic_string(name_arg):
                if _is_dynamic_string(name_arg):
                    self._flag(
                        name_arg, "OBS002",
                        _expr_source(name_arg)[:60],
                    )
                for kw in node.keywords:
                    if kw.arg is None or kw.arg in _NON_LABEL_KWARGS:
                        continue
                    why = _suspicious_label(kw.value)
                    if why:
                        self._flag(
                            kw.value, "OBS001", f"label {kw.arg}={why}"
                        )
        self.generic_visit(node)


def lint_file(path: Path) -> list[Violation]:
    try:
        source, tree = parse_file(path)
    except (OSError, SyntaxError, UnicodeDecodeError):
        return []
    v = _Visitor(_rel(path), source.splitlines())
    v.visit(tree)
    return v.out


def lint_paths(paths: Iterable[str | Path]) -> list[Violation]:
    from trino_tpu_torch.lint.jit_safety import REPO_ROOT

    out: list[Violation] = []
    for p in paths:
        p = Path(p)
        if not p.is_absolute() and not p.exists():
            p = REPO_ROOT / p
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f))
    return sorted(out, key=lambda v: (v.path, v.lineno, v.rule))
